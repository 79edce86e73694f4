"""Command-line entry points of the port, run as `python -m fdt_torch.cli.<name>`:
serve, my_test, my_test_facebox, my_test_mtcnn, merge_eval, draw_curves,
track_video, track_display, video_demo, train_pyramid, train_chained,
train_facebox, train_net2net, train_mtcnn, gen_mtcnn_data, gen_anno,
export_weights and select_checkpoint (the counterparts of fdt's scripts/
of the same names)."""
