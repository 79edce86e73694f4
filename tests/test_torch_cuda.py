"""fdt_torch's CUDA kernels against their plain versions, on the card.

This file imports neither jax nor fdt, so it runs on the GPU machine, which
has neither (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips.
"""
import hashlib
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt_torch.geometry import nms  # noqa: E402
from fdt_torch.ops import nms as nms_op  # noqa: E402

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _boxes(rng, shape, spread):
    centers = rng.rand(*shape, 2) * spread
    wh = rng.rand(*shape, 2) * 3.0 + 0.5
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_kernel_keep_mask_bit_equal_to_plain(card, mode):
    rng = np.random.RandomState(0)
    boxes = torch.from_numpy(_boxes(rng, (3, 1500), 20.0)).to(card)
    valid = torch.from_numpy(rng.rand(3, 1500) > 0.2).to(card)
    seg = torch.from_numpy((rng.rand(3, 1500) * 5).astype(np.int32)).to(card)
    for seg_id in (None, seg):
        before = nms_op.launches.count
        got = nms_op.nms_keep_tiled(boxes, valid, 0.4, mode=mode, seg_id=seg_id)
        assert nms_op.launches.count == before + 1
        assert torch.equal(got, nms.nms_keep_mask(boxes, valid, 0.4, mode=mode,
                                                  seg_id=seg_id))


def test_nms_padded_on_card_equals_cpu(card):
    """Sort, kernel and compaction on the card give the CPU's indices."""
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, (2, 3, 3000), 60.0)
    scores = (rng.randint(0, 50, (2, 3, 3000)) / 49).astype(np.float32)  # many ties
    args = dict(budget=2500, out_k=300)
    idx_c, cnt_c = nms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.35,
                                  valid=torch.from_numpy(scores > 0.1), **args)
    idx_g, cnt_g = nms.nms_padded(torch.from_numpy(boxes).to(card),
                                  torch.from_numpy(scores).to(card), 0.35,
                                  valid=torch.from_numpy(scores > 0.1).to(card), **args)
    assert torch.equal(cnt_g.cpu(), cnt_c)
    for i, c in np.ndenumerate(cnt_c.numpy()):
        assert torch.equal(idx_g.cpu()[i][:c], idx_c[i][:c])


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    boxes = torch.zeros(2, 10, 4, device=card)
    valid = torch.ones(2, 10, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="float32"):
        nms_op.nms_keep_tiled(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_op.nms_keep_tiled(boxes.transpose(0, 1).contiguous().transpose(0, 1), valid, 0.5)
    with pytest.raises(ValueError, match="int32"):
        nms_op.nms_keep_tiled(boxes, valid, 0.5, seg_id=torch.zeros(2, 10, device=card))
    # past the kernel's limits: more than 65535 words of 64 boxes, more than
    # 65535 problems (grid.z of the mask launch)
    for p, n in ((1, 64 * nms_op._MAX_WORDS + 1), (65536, 1)):
        with pytest.raises(ValueError, match="too large"):
            nms_op.nms_keep_tiled(torch.zeros(p, n, 4, device=card),
                                  torch.ones(p, n, dtype=torch.bool, device=card), 0.5)


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_greedy_kernel_bit_equal_to_plain_and_k1(card, mode):
    """K2 against its plain version and against K1, with a degenerate
    (zero-area) box whose 0/0 overlaps must suppress nothing."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, (3, 2000), 20.0)
    boxes[:, 5] = boxes[:, 5, :2].repeat(2, axis=-1)  # x2 = x1, y2 = y1
    boxes = torch.from_numpy(boxes).to(card)
    valid = torch.from_numpy(rng.rand(3, 2000) > 0.2).to(card)
    valid[:, 1900:] = False  # an extent short of N
    before = nms_op.greedy_launches.count
    got = nms_op.nms_keep_greedy(boxes, valid, 0.4, mode=mode)
    assert nms_op.greedy_launches.count == before + 1
    assert torch.equal(got, nms.nms_keep_mask(boxes, valid, 0.4, mode=mode))
    assert torch.equal(got, nms_op.nms_keep_tiled(boxes, valid, 0.4, mode=mode))


def test_nms_padded_impls_agree_on_card(card):
    """impl="pallas" (K2), "pallas_tiled" (K1), "xla" and "auto" give the same
    indices and counts on the card as on the CPU."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, (4, 2048), 50.0)
    scores = rng.rand(4, 2048).astype(np.float32)
    args = dict(budget=2048, out_k=750)
    idx_c, cnt_c = nms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                  valid=torch.from_numpy(scores > 0.35), **args)
    for impl in ("pallas", "pallas_tiled", "xla", "auto"):
        idx_g, cnt_g = nms.nms_padded(torch.from_numpy(boxes).to(card),
                                      torch.from_numpy(scores).to(card), 0.5,
                                      valid=torch.from_numpy(scores > 0.35).to(card),
                                      impl=impl, **args)
        assert torch.equal(cnt_g.cpu(), cnt_c), impl
        for i, c in enumerate(cnt_c.tolist()):
            assert torch.equal(idx_g.cpu()[i][:c], idx_c[i][:c]), impl


def test_greedy_wrapper_rejects_more_boxes_than_shared_memory_holds(card):
    boxes = torch.zeros(1, 8193, 4, device=card)
    with pytest.raises(ValueError, match="too large"):
        nms_op.nms_keep_greedy(boxes, torch.ones(1, 8193, dtype=torch.bool, device=card), 0.5)


@pytest.mark.parametrize("name", chip_smoke.K1_EDGES)
def test_kernel_bit_equal_to_plain_at_the_walks_edges(card, name):
    """K1 on chip_smoke.K1_EDGES: out_k at a word end, at chunk ends, in the
    middle of a word and above the keeps; no valid box; one at the last
    index; N = 1, 63, 64, 65 and 8192; segments across chunks; zero-area and
    NaN boxes; P = 1 and 16."""
    boxes, valid, seg, mode, thresh, out_k = (
        torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
        for a in chip_smoke.k1_edge_case(name))
    before = nms_op.launches.count
    got = nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode, seg_id=seg, out_k=out_k)
    assert nms_op.launches.count == before + 1
    want = nms.nms_keep_mask(boxes, valid, thresh, mode=mode, seg_id=seg)
    assert chip_smoke._mask_err(got, want, out_k) == 0.0
    if out_k is not None:  # entries past the out_k-th keep read 0
        assert int(got.sum(-1).max()) <= out_k


def _k2_edge(name, card):
    return tuple(torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
                 for a in chip_smoke.k2_edge_case(name))


@pytest.mark.parametrize("name", chip_smoke.K2_EDGES)
def test_greedy_kernel_bit_equal_to_plain_and_k1_at_its_edges(card, name):
    """K2 on chip_smoke.K2_EDGES: problems smaller than a word and than a
    cluster's words; the word and owner boundaries at 8 and 16 words;
    an extent inside a word; no valid box, or only the last; a suppression
    chain across owners; every box kept; identical boxes; zero-area and NaN
    boxes; thresh 0; P = 64; N = 8192."""
    boxes, valid, mode, thresh = _k2_edge(name, card)
    before = nms_op.greedy_launches.count
    got = nms_op.nms_keep_greedy(boxes, valid, thresh, mode=mode)
    assert nms_op.greedy_launches.count == before + 1
    assert torch.equal(got, nms.nms_keep_mask(boxes, valid, thresh, mode=mode))
    assert torch.equal(got, nms_op.nms_keep_tiled(boxes, valid, thresh, mode=mode))


@pytest.fixture
def tf32_flags_on():
    """The global TF32 flags on, as torch leaves cuDNN's by default."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("family", ["flagship", "facebox"])
def test_float32_detector_matches_golden_with_the_global_tf32_flags_on(card, tf32_flags_on,
                                                                       family):
    """The default precision="highest" turns TF32 off for the forward, as
    fdt's detectors compute in full float32, and restores the flags."""
    from fdt_torch.infer import FaceBoxDetector, PyramidBoxDetector
    from fdt_torch.models import FaceBox, from_jax_variables, load_pyramidbox

    if family == "flagship":
        g = np.load(chip_smoke.GOLDEN)
        frame = chip_smoke.golden_frame(int(g["seed"]), int(g["height"]), int(g["width"]))
        det = PyramidBoxDetector(load_pyramidbox(str(chip_smoke.WEIGHTS)), device=card)
        rows = det.detect_tensor(frame[None], float(g["conf_thresh"]),
                                 float(g["nms_thresh"]))[0, 1]
    else:
        g = np.load(chip_smoke.FACEBOX_GOLDEN)
        frame = chip_smoke.golden_frame(int(g["frame_seed"]), int(g["size"]), int(g["size"]))
        model = FaceBox()
        model.load_state_dict(from_jax_variables(
            chip_smoke.seeded_variables(model, int(g["weights_seed"]))), strict=True)
        (boxes, scores), = FaceBoxDetector(model, device=card).detect_batch(frame[None])
        rows = np.column_stack([scores, boxes])
    assert hashlib.sha256(frame.tobytes()).hexdigest() == str(g["frame_sha256"])
    chip_smoke.match_rows(rows, g["rows"], chip_smoke.GOLDEN_ROWS, chip_smoke.GOLDEN_TOL)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_mtcnn_sparse_golden_on_card(card, tf32_flags_on):
    """The MTCNN cascade at 480×640 through bench.py's ladder on the sparse
    golden batch: fdt's counts, flags and tier; scores within 1e-3, boxes and
    landmarks within 1e-2 px (chip_smoke.check_mtcnn_golden)."""
    cascade = chip_smoke.mtcnn_cascade("sparse", card)
    before = nms_op.launches.count
    chip_smoke.check_mtcnn_golden(cascade)
    assert nms_op.launches.count - before == 4 * 2  # FAST saturates, MID answers
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("crop_impl", ["gather", "matmul"])
def test_mtcnn_cascade_on_card_equals_cpu(card, crop_impl):
    """The whole cascade on the card against the port on the CPU, both
    crop forms, at 120×160 on the saturated weights and FAST_BUDGETS."""
    from fdt_torch.infer import FAST_BUDGETS, MTCNNDeviceCascade
    from fdt_torch.models import load_mtcnn_nets

    images = np.stack([chip_smoke.golden_frame(s, 120, 160) for s in (1, 2)])
    out = {}
    for device in ("cpu", card):
        nets = load_mtcnn_nets(*chip_smoke.mtcnn_variables("saturated"))
        cascade = MTCNNDeviceCascade(*nets, budgets=FAST_BUDGETS, crop_impl=crop_impl,
                                     device=device)
        out[str(device)] = cascade.detect_batch(images)
    cpu, gpu = out["cpu"], out[str(card)]
    np.testing.assert_array_equal(gpu[2], cpu[2])
    np.testing.assert_array_equal(gpu[3], cpu[3])
    for i, c in enumerate(cpu[2]):
        chip_smoke.match_detections(gpu[0][i, :c], gpu[1][i, :c], cpu[0][i, :c], cpu[1][i, :c],
                                    1e-4, 1e-2)


def test_k1_bit_equal_on_saturated_mtcnn_candidates(card):
    """K1's segmented path on the saturated cascade's own per-level
    candidates at 480×640 (N = 8192), one launch for the batch, against its
    plain version."""
    cascade = chip_smoke.mtcnn_cascade("saturated", card)
    frames = np.stack([chip_smoke.golden_frame(s, chip_smoke.MTCNN_H, chip_smoke.MTCNN_W)
                       for s in (0, 1)])
    boxes, valid, seg = cascade.pnet_candidates(frames, tier="full")
    assert boxes.shape == (2, 8192, 4) and bool(valid.all())
    before = nms_op.launches.count
    got = nms_op.nms_keep_tiled(boxes, valid, 0.4, mode="minimum", seg_id=seg)
    assert nms_op.launches.count == before + 1
    assert torch.equal(got, nms.nms_keep_mask(boxes, valid, 0.4, mode="minimum", seg_id=seg))


@pytest.mark.parametrize("name", chip_smoke.TRACK_EDGES)
def test_track_kernel_bit_equal_to_plain_at_its_edges(card, name):
    """K3 on chip_smoke.TRACK_EDGES: frames with no rows and with only the
    sentinel row, the NaN of a sentinel-born track meeting a zero-area row,
    ties in IoU and distance, both modes, pad widths 1, 32, 33, 64 and 750,
    a chunk that overflows t_max = 8, more than 64 live tracks, -0.0 tied
    with +0.0, infinite boxes, a T past shared memory (the device-memory
    variant), more live slots than a tile of affinities.  Every record and
    the state after each chunk bit-equal, one launch a chunk."""
    from fdt_torch.ops import track as track_op

    cfg, t_max, chunks = chip_smoke.track_edge_case(name)
    before = track_op.global_launches.count
    assert chip_smoke.check_k3_chunks(cfg, t_max, chunks, card) == len(chunks)
    variant = chip_smoke.k3_rows(t_max, chunks[0][2].shape[1])
    assert (track_op.global_launches.count - before == 0) == (variant > 0)


def test_track_kernel_variants_on_a_tracker_growing_past_shared_memory(card):
    """A DeviceIoUTracker growing from t_max 8 and pad width 64 to 2048 ×
    2048 (chip_smoke.check_k3_growth): both variants launch, every call
    bit-equal to the plain version, tracks equal to the host tracker's."""
    got = chip_smoke.check_k3_growth(card)
    assert got["smem"] > 0 and got["global"] > 0 and got["t_max"] >= 2048


def test_track_size_cases_reach_both_variants_and_several_tiles(card):
    """By the kernel's own plan on this card: t-over-smem is past the
    shared-memory variant (the device-memory one runs); tile-rows walks
    more live slots than one tile of affinities holds; bench.py's density
    fits one tile."""
    _, t_max, chunks = chip_smoke.track_edge_case("t-over-smem")
    assert chip_smoke.k3_rows(t_max, chunks[0][2].shape[1]) == 0
    cfg, t_max, chunks = chip_smoke.track_edge_case("tile-rows")
    rows = chip_smoke.k3_rows(t_max, chunks[0][2].shape[1])
    assert 0 < rows < chip_smoke.k3_work(cfg, t_max, chunks)["most_live"]
    assert (chip_smoke.k3_rows(chip_smoke.TRACK_T_MAX, chip_smoke.TRACK_DET_CAP)
            == chip_smoke.TRACK_T_MAX)


def test_fused_tracker_on_card_equals_its_unfused_path(card):
    """FusedVideoTracker (detect, post and K3 on the card, one read a chunk)
    against detect_tensor → detections_to_rows → the host IoUTracker at the
    same chunk shapes, new trackers at t_max 256 and, through the
    grow-and-redo path, 2 (chip_smoke.check_fused): seeded try3 at 128², a
    frame rolled 3 px a frame, two chunks of 3 frames, at chip_smoke's
    TRACK_CHECK setting; the tracks compared are not empty and extend."""
    import dataclasses

    from fdt_torch.config import TRACKER
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import build_pyramidbox, from_jax_variables

    model = build_pyramidbox("try3")
    model.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(model, 0)),
                          strict=True)
    det = PyramidBoxDetector(model, "try3", device=card)
    base = np.random.RandomState(7).randint(0, 255, (128, 128, 3), np.uint8)
    frames = np.stack([np.roll(base, 3 * f, axis=1) for f in range(6)])
    chunks = [torch.from_numpy(frames[c:c + 3]).to(card) for c in (0, 3)]
    got = chip_smoke.check_fused(det, chunks, dataclasses.replace(TRACKER,
                                                                  **chip_smoke.TRACK_CHECK))
    assert min(got["rows"]) > 0 and got["track_frames"] > got["tracks"] > 0
    assert got["redo_t_max"] > 2


def test_track_wrapper_rejects_what_the_kernel_does_not_take(card):
    from fdt_torch.config import TRACKER
    from fdt_torch.ops import track as track_op
    from fdt_torch.geometry.track import init_slots

    _, t_max, chunks = chip_smoke.track_edge_case("iou-mode")
    boxes, scores, valid = (torch.from_numpy(a).to(card) for a in chunks[0])
    slots = init_slots(t_max, card)
    with pytest.raises(ValueError, match="float32"):
        track_op.associate_chunk(slots, boxes.double(), scores, valid, TRACKER)
    with pytest.raises(ValueError, match="boxes on cpu"):
        track_op.associate_chunk(slots, boxes.cpu(), scores, valid, TRACKER)
    with pytest.raises(ValueError, match="contiguous"):
        track_op.associate_chunk(slots, boxes.transpose(0, 1).contiguous().transpose(0, 1),
                                 scores, valid, TRACKER)


@pytest.fixture
def try3_on_card(card):
    """The trained try3 detector (net_weight/try3_mini.npz), float32, on the card."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import load_pyramidbox

    return PyramidBoxDetector(load_pyramidbox(str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"]),
                                              "try3"), "try3", device=card)


def test_http_server_on_card_answers_as_direct_calls(try3_on_card):
    """PNG bodies POSTed from 4 threads to make_http_server around a card
    service: each answer against a direct detect_tensor call on its frame
    (float32, another batch size: 1e-4 in scores, 0.05 px), K1 once a batch
    run eagerly, twice a capture, never a replay (chip_smoke.k1_through_graphs)."""
    import threading

    from fdt_torch.apps.serving import DetectionService, make_http_server
    from fdt_torch.infer import detections_to_rows

    det, h, w, threshold = try3_on_card, 128, 160, 0.05
    rng = np.random.RandomState(12)
    frames = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(8)]
    want = []
    for f in frames:
        r = detections_to_rows(det.detect_tensor(f[None], threshold, 0.35)[0], threshold,
                               [w, h, w, h])
        want.append(r if r[:, :4].any() else np.empty((0, 5), np.float32))
    assert sum(map(len, want)) > 0
    svc = DetectionService("pyramidbox", det, frame_size=(w, h), threshold=threshold,
                           max_batch=4, max_wait_ms=20)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        before = chip_smoke.graph_counts()
        nms_op.launches.reset()
        got, _, _ = chip_smoke._http_burst(
            f"http://127.0.0.1:{server.server_address[1]}/detect",
            [chip_smoke.encode_png(f) for f in frames])
        assert svc.stats()["batches"] > 0
        assert (nms_op.launches.count, svc.stats()["batches"]) == chip_smoke.k1_through_graphs(
            before)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    for i in range(len(frames)):
        assert chip_smoke._rows_agree(got[i], want[i], threshold, 1e-4, 0.05)


def test_eval_pyramidbox_on_card_equals_direct_detect_face(try3_on_card, tmp_path):
    """eval_pyramidbox on PNG files of three sizes: the dump bit-equal to one
    built from direct detect_face calls, one K1 launch an image run eagerly
    (two a capture, none a replay: chip_smoke.k1_through_graphs)."""
    from fdt_torch.eval.runner import eval_pyramidbox

    det = try3_on_card
    images = chip_smoke.eval_images(seed=1, n=6, sizes=((128, 160), (96, 128), (200, 150)))
    want = [det.detect_face(im, 0.0) for im in images]
    rng = np.random.RandomState(0)
    anno = chip_smoke.write_eval_set(
        tmp_path, images, [chip_smoke.gt_boxes(r, *im.shape[:2], rng)
                           for r, im in zip(want, images)])
    before = chip_smoke.graph_counts()
    nms_op.launches.reset()
    dump = eval_pyramidbox(det, anno, 0.0, progress=False)
    assert (nms_op.launches.count, len(images)) == chip_smoke.k1_through_graphs(before)
    np.testing.assert_array_equal(dump, chip_smoke.reference_dump(want, anno))
    assert dump[0, :-1].sum() > 0


@pytest.fixture
def try3_tracker_on_card(card):
    """The trained try3 on the card detecting at conf 0.05 / NMS 0.35, six
    frames of a seeded 128² frame panned 3 px, and a tracker setting at
    chip_smoke's TRACK_CHECK whose floor passes rows a frame."""
    import dataclasses

    from fdt_torch.config import TRACKER, DetectConfig
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import load_pyramidbox

    det = PyramidBoxDetector(load_pyramidbox(str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"]),
                                             "try3"), "try3", device=card,
                             detect_cfg=dataclasses.replace(DetectConfig(), conf_thresh=0.05,
                                                            nms_thresh=0.35))
    base = np.random.RandomState(7).randint(0, 255, (128, 128, 3), np.uint8)
    frames = [np.roll(base, 3 * f, axis=1) for f in range(6)]
    cfg = dataclasses.replace(TRACKER, score_floor=0.08, **chip_smoke.TRACK_CHECK)
    return det, frames, cfg


def test_video_legs_on_card_equal_the_unfused_path(try3_tracker_on_card):
    """track_video (host and device trackers) and track_video_fused on the
    card at batch 3: tracks equal to chip_smoke.unfused_tracks on chunks of 3
    (same_tracks), one K1 call a batch (through the detector's graphs as
    chip_smoke.k1_through_graphs counts), one K3 launch a batch where the
    association runs on the card."""
    from fdt_torch.ops import track as track_op
    from fdt_torch.track import track_video, track_video_fused

    det, frames, cfg = try3_tracker_on_card
    chunks = [torch.from_numpy(np.stack(frames[c:c + 3])).to(det.device) for c in (0, 3)]
    want, _, _ = chip_smoke.unfused_tracks(det, chunks, cfg, cap=None)
    assert want
    legs = {"host": lambda: track_video(frames, det, cfg, batch_size=3, frame_size=(128, 128)),
            "device": lambda: track_video(frames, det, cfg, batch_size=3, frame_size=(128, 128),
                                          device_tracker=True),
            "fused": lambda: track_video_fused(frames, det, cfg, batch_size=3,
                                               frame_size=(128, 128))}
    for leg, run in legs.items():
        nms_op.launches.reset()
        track_op.launches.reset()
        track_op.global_launches.reset()
        before = chip_smoke.graph_counts()
        got = run()
        assert chip_smoke.same_tracks(got, want), leg
        graph_k1, graph_calls = chip_smoke.k1_through_graphs(before)
        assert nms_op.launches.count == 2 - graph_calls + graph_k1
        assert track_op.launches.count + track_op.global_launches.count == (
            0 if leg == "host" else 2)


def test_mtcnn_host_cascade_on_card(card):
    """The host cascade with its nets on the card: against the same cascade
    on the CPU at 120×160 (counts equal, 1e-3 px, 1e-4 in score: the nets'
    float32 sums differ), and against fdt's golden at 480×640 within the
    golden's bound (chip_smoke.check_mtcnn_host_golden)."""
    image = chip_smoke.golden_frame(1, 120, 160)
    got = chip_smoke.host_cascade(card).detect_face(image)
    want = chip_smoke.host_cascade("cpu").detect_face(image)
    assert got[0].shape == want[0].shape and len(want[0])
    chip_smoke.match_unordered(*got, *want, 1e-4, 1e-3)
    out = chip_smoke.check_mtcnn_host_golden(chip_smoke.host_cascade(card),
                                             chip_smoke.mtcnn_host_frames())
    assert max(out["unmatched"]) <= chip_smoke.MTCNN_HOST_COUNT_DIFF


@pytest.mark.parametrize("name", chip_smoke.INT8_EDGES)
def test_int8_kernels_bit_equal_to_plain_at_their_edges(card, name):
    """K5 and K4 on chip_smoke.INT8_EDGES (K = 147, N = 2 and 4, grouped,
    dilated, the zero tensor, NaN and inf, bf16 and float32, NCHW and
    channels-last) against their plain versions on the card, one launch of
    each wrapper."""
    from fdt_torch.ops import quant

    x, conv, _ = chip_smoke.int8_edge_case(name, card)
    before = chip_smoke._int8_counts()[:2]
    assert chip_smoke.check_int8_conv(conv, x) == (0.0, 0.0)
    assert chip_smoke._int8_counts()[:2] == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name", chip_smoke.INT8_TILE_EDGES)
def test_int8_wgmma_tiles_bit_equal_to_plain(card, name):
    """K4's wgmma variant on chip_smoke.INT8_TILE_EDGES (N tiles of 8 to 256
    with ragged N and M, K past its last stage, stride 2, dilation 3,
    float32 outputs through strides, more tiles than SMs) and K5 past one
    turn of its resident grid, against their plain versions."""
    from fdt_torch.ops import quant

    x, conv, _ = chip_smoke.int8_edge_case(name, card)
    before = quant.launches.count
    assert chip_smoke.check_int8_conv(conv, x) == (0.0, 0.0)
    assert quant.launches.count == before + 1  # every tile edge takes the wgmma variant


def test_int8_k4_variants_launch_as_picked(card):
    """Each K4 call launches the variant conv_variant names: the wgmma one
    for 110 of the flagship's 111 int8 convs (the 3-channel stem takes
    mma_sync) and on the edges it takes, mma_sync on the grouped, 3- and
    12-channel edges and on an activation one byte off 16-byte alignment."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import load_pyramidbox
    from fdt_torch.ops import quant

    det = PyramidBoxDetector(load_pyramidbox(str(chip_smoke.WEIGHTS)), dtype=torch.bfloat16,
                             device=card, quant="int8")
    frames = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(card)
    picks = chip_smoke.k4_picks(det.model, lambda: det.detect_device(frames))
    assert picks == {"wgmma": 110, "mma_sync": 1}
    before = chip_smoke._k4_counts()
    det.detect_device(frames)
    after = chip_smoke._k4_counts()
    assert {v: after[v] - before[v] for v in after} == picks
    for name in chip_smoke.INT8_EDGES:
        x, conv, _ = chip_smoke.int8_edge_case(name, card)
        xq, _ = quant.quantize_int8(x)
        want = quant.conv_variant(xq.shape[-1], conv.groups, xq.data_ptr())
        before = chip_smoke._k4_counts()
        conv(x)
        after = chip_smoke._k4_counts()
        assert {v: after[v] - before[v] for v in after} == {
            v: int(v == want) for v in after}, name
    # the same q one byte into its storage: not 16-byte aligned
    x, conv, _ = chip_smoke.int8_edge_case("head-n4-bf16-cl", card)
    xq, sx = quant.quantize_int8(x)
    storage = torch.empty(xq.numel() + 1, dtype=torch.int8, device=card)
    storage[1:] = xq.reshape(-1)
    shifted = storage[1:].view(xq.shape)
    wpack, sw = conv._int8
    args = dict(kernel=conv.kernel_size, stride=conv.stride, padding=conv.padding,
                dilation=conv.dilation, groups=1, out_dtype=x.dtype, channels_last=True)
    before = chip_smoke._k4_counts()
    got = quant.conv_int8(shifted, sx, wpack, sw, conv.bias, **args)
    after = chip_smoke._k4_counts()
    assert {v: after[v] - before[v] for v in after} == {"wgmma": 0, "mma_sync": 1}
    assert torch.equal(got, quant.conv_int8(xq, sx, wpack, sw, conv.bias, **args))


def test_int8_k5_one_launch_a_call(card):
    """K5 is one kernel launch a call, on the bf16 channels-last path and the
    float32 NCHW one alike (torch.profiler's kernels of one call)."""
    from torch.profiler import ProfilerActivity, profile

    from fdt_torch.ops import quant

    for name in ("past-caps-bf16-cl", "past-caps-f32-nchw", "offset-view-bf16-cl"):
        x, _, _ = chip_smoke.int8_edge_case(name, card)
        quant.quantize_int8(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            quant.quantize_int8(x)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "kernel" in e.name]
        assert len(kernels) == 1 and "quantize_int8_kernel" in kernels[0], (name, kernels)


def test_int8_flagship_convs_bit_equal_to_plain_on_their_inputs(card):
    """Every int8 conv that a bf16 int8 flagship detect runs (111: the
    head-supervision convs never run), K5 and K4 on the conv's own input
    against their plain versions."""
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import load_pyramidbox

    det = PyramidBoxDetector(load_pyramidbox(str(chip_smoke.WEIGHTS)), dtype=torch.bfloat16,
                             device=card, quant="int8")
    frames = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(card)
    out = chip_smoke.check_int8_model(det.model, lambda: det.detect_device(frames))
    assert out["convs"] == 111 and out["k5_err"] == out["k4_err"] == 0.0
    assert out["kernels"] == [(1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 1, 2), (3, 2, 1), (7, 2, 1)]


def test_int8_wrappers_raise_and_never_fall_back_on_card(card, monkeypatch):
    """A CUDA tensor the kernels do not take raises, and a failed launch
    raises: neither gives way to the plain version."""
    from fdt_torch.ops import _build, quant

    x = torch.randn(1, 8, 6, 6, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant.quantize_int8(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8(x[:, :, ::2])
    conv = quant.Int8Conv2d(8, 4, 3, padding=1).to(card)
    conv.quantize_weights()
    xq, sx = quant.quantize_int8(x)
    wpack, sw = conv._int8
    args = dict(kernel=(3, 3), stride=(1, 1), padding=(1, 1), dilation=(1, 1), groups=1,
                out_dtype=torch.float32, channels_last=False)
    with pytest.raises(ValueError, match="must be on"):
        quant.conv_int8(xq, sx.cpu(), wpack, sw, None, **args)
    with pytest.raises(ValueError, match="int8"):
        quant.conv_int8(xq.float(), sx, wpack, sw, None, **args)
    with pytest.raises(ValueError, match="contiguous"):
        quant.conv_int8(xq.transpose(1, 2), sx, wpack, sw, None, **args)

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 1 if name in ("fdt_conv_int8", "fdt_quantize_int8") else 4

    monkeypatch.setattr(_build, "library", lambda: Failing())
    with pytest.raises(RuntimeError, match="fdt_quantize_int8 launch failed"):
        quant.quantize_int8(x)
    with pytest.raises(RuntimeError, match="fdt_conv_int8 launch failed"):
        quant.conv_int8(xq, sx, wpack, sw, None, **args)


def _cut_flagship_trainer(device, **kw):
    from fdt_torch.models import PyramidBox
    from fdt_torch.train.loops import PyramidTrainer, xavier_init
    return PyramidTrainer(xavier_init(PyramidBox((1, 1, 1, 1), remat=kw.pop("remat", False)), 0),
                          "repo", input_size=128, precision="highest", device=device, **kw)


def test_train_step_on_card_matches_cpu(card):
    """One step of the depth-cut flagship (one Bottleneck a stage) at 128²,
    batch 2, float32 "highest", on the card and on the CPU from the same
    xavier weights: losses within 1e-4, every change within 1e-2 of the
    step's largest change (cuDNN's and the CPU's sums differ in order), the
    running statistics within 1e-3; a remat step on the card stores the
    plain step's statistics."""
    from fdt_torch.models.loader import to_jax_variables
    batch = chip_smoke.train_batch(0, 2, 128)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    before = dict(leaves(to_jax_variables(_cut_flagship_trainer("cpu").model)))
    runs = {}
    for name, dev, kw in (("cpu", "cpu", {}), ("card", card, {}), ("remat", card, {"remat": True})):
        t = _cut_flagship_trainer(dev, **kw)
        m = t.train_step(*batch, 1e-3)
        runs[name] = ({k: float(v) for k, v in m.items()}, dict(leaves(to_jax_variables(t.model))))
    for k, v in runs["cpu"][0].items():
        assert abs(runs["card"][0][k] - v) <= 1e-4 * abs(v), k
    got, want = runs["card"][1], runs["cpu"][1]
    scale = max(np.abs(want[k] - before[k]).max() for k in want if k.startswith("params/"))
    for k in want:
        if k.startswith("params/"):
            assert np.abs((got[k] - before[k]) - (want[k] - before[k])).max() <= 1e-2 * scale, k
        else:
            assert np.abs(got[k] - want[k]).max() <= 1e-3 * np.abs(want[k]).max() + 1e-6, k
            np.testing.assert_array_equal(runs["remat"][1][k], got[k], err_msg=k)


def _card_against_cpu(make_trainer, step, card, steps: int = 2, loss_rtol: float = 1e-4,
                      change_rtol: float = 1e-2, sign_share: float | None = None):
    """`steps` steps of make_trainer(device) on the card and on the CPU from
    the same weights: every metric within loss_rtol, every parameter change
    within change_rtol of the largest change of any leaf, the running
    statistics within 1e-3 of each leaf's largest value, and, given
    sign_share, the changes' signs (chip_smoke.change_signs) the same but
    for at most that share of the elements."""
    from fdt_torch.models.loader import flat_variables, to_jax_variables
    before = flat_variables(to_jax_variables(make_trainer("cpu").model))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", card)):
        t = make_trainer(dev)
        metrics = [step(t) for _ in range(steps)]
        runs[name] = (metrics, flat_variables(to_jax_variables(t.model)))
    for got, want in zip(runs["card"][0], runs["cpu"][0]):
        np.testing.assert_allclose(got, want, rtol=loss_rtol)
    got, want = runs["card"][1], runs["cpu"][1]
    scale = max(np.abs(want[k] - before[k]).max() for k in want if k.startswith("params/"))
    for k in want:
        if k.startswith("params/"):
            assert np.abs((got[k] - before[k]) - (want[k] - before[k])).max() <= change_rtol * scale, k
        else:
            assert np.abs(got[k] - want[k]).max() <= 1e-3 * np.abs(want[k]).max() + 1e-6, k
    if sign_share is not None:
        flipped = np.mean(chip_smoke.change_signs(before, got)
                          != chip_smoke.change_signs(before, want))
        assert flipped <= sign_share, flipped


def test_facebox_train_step_on_card_matches_cpu(card):
    """FaceBoxes at 128² (maps 4/2/1), batch 2, float32 "highest", 2 steps at
    lr 1e-3 from seeded weights, on the card and on the CPU."""
    import dataclasses

    from fdt_torch.config import FACEBOX
    from fdt_torch.models import FaceBox, from_jax_variables
    from fdt_torch.train.facebox_train import FaceBoxTrainer
    cfg = dataclasses.replace(FACEBOX, input_size=128, feature_map_sizes=(4, 2, 1))
    batch = chip_smoke.facebox_train_batch(0, 2, 128)

    def make(dev):
        model = FaceBox()
        model.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(model, 0)))
        return FaceBoxTrainer(model, cfg=cfg, precision="highest", device=dev)

    _card_against_cpu(make, lambda t: [float(v) for v in t.train_step(*batch, 1e-3).values()],
                      card)


def test_net2net_step_on_card_matches_cpu(card):
    """net2net intermedia, try1 → try1 at 160², batch 2, float32 "highest",
    2 steps at lr 1e-7 from seeded weights, on the card and on the CPU."""
    from fdt_torch.models import build_pyramidbox, from_jax_variables
    from fdt_torch.train.net2net import Net2NetTrainer
    images = chip_smoke.net2net_batch(0, 2, 160)[0]

    def make(dev):
        nets = []
        for seed in (0, 1):
            m = build_pyramidbox("try1")
            m.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(m, seed)))
            nets.append(m)
        return Net2NetTrainer(*nets, "intermedia", input_size=160, precision="highest",
                              device=dev)

    def step(t):
        m = t.train_step(images, 1e-7)
        return [float(m["loss"])] + m["parts"].cpu().tolist()

    _card_against_cpu(make, step, card)


@pytest.mark.parametrize("stage", ["pnet", "rnet", "onet"])
def test_mtcnn_train_step_on_card_matches_cpu(card, stage):
    """An MTCNN stage, batch 64 of seeded patches with every label kind,
    float32 "highest", 2 Adam steps at lr 1e-3 from seeded weights, on the
    card and on the CPU; the changes' signs agree but for at most 1e-3 of
    the elements (Adam moves each by ~lr whatever its gradient)."""
    from fdt_torch.models import ONet, PNet, RNet, from_jax_variables
    from fdt_torch.train.mtcnn_train import MTCNNStageTrainer
    batch = chip_smoke.mtcnn_train_batch(stage, 0, 64)

    def make(dev):
        net = {"pnet": PNet, "rnet": RNet, "onet": ONet}[stage]()
        net.load_state_dict(from_jax_variables(chip_smoke.seeded_variables(net, 2),
                                               net.flatten_chw))
        return MTCNNStageTrainer(stage, 1e-3, "highest", model=net, device=dev)

    _card_against_cpu(make, lambda t: [float(v) for v in t.train_step(*batch).values()], card,
                      change_rtol=2e-2, sign_share=1e-3)


def test_pth_flagship_bit_equal_to_npz_on_card(card, tmp_path):
    """The flagship from a .pth in fdt's flax_to_torch layout (written from
    repo_mini.npz) detects on the card bit-equal to the npz-loaded one, K1
    once a detect; a .pth written from the card model reloads bit-equal."""
    from fdt_torch.models import (load_npz, load_pyramidbox, load_pyramidbox_detector,
                                  save_variables_pth)
    pth = str(tmp_path / "repo.pth")
    save_variables_pth(load_npz(str(chip_smoke.WEIGHTS)), pth)
    frames = torch.from_numpy(chip_smoke.flagship_batch()[:2]).to(card)
    outs = []
    for weights in (str(chip_smoke.WEIGHTS), pth):
        det = load_pyramidbox_detector("repo", weights, device=card)
        before = nms_op.launches.count
        outs.append(det.detect_device(frames, conf_thresh=0.05))
        torch.cuda.synchronize()
        assert nms_op.launches.count == before + 1
    assert torch.equal(outs[0], outs[1]) and (outs[0][:, 1, :, 0] > 0.05).any()
    save_variables_pth(det.model, str(tmp_path / "again.pth"))
    assert chip_smoke.same_state(load_pyramidbox(str(tmp_path / "again.pth")), det.model)


def test_inception_on_card_matches_cpu(card):
    """Inception-ResNet-v2 at full depth, 299², batch 2, float32 "highest"
    (TF32 off), seeded weights: the card's logits within
    chip_smoke.INCEPTION_TOL of the scale of the CPU's, not washed out."""
    from fdt_torch.infer.pyramidbox import tf32_for
    model = chip_smoke.seeded_inception()
    images = chip_smoke.inception_images(2)
    with torch.no_grad():
        want = model(images)
        with tf32_for("highest"):
            got = model.to(card)(images.to(card))
    chip_smoke.check_inception(got, want)


def test_dp_inference_on_every_card_launches_there(card):
    """try3 on make_mesh over every card (two slots of cuda:0 on a one-card
    machine), 5 images: each card's shard runs K1 there, checked against
    its plain version on the same boxes (chip_smoke.k1_checked), and the
    answer equals the unsharded detector's within fdt's DP tolerance."""
    from fdt_torch.dist import make_mesh
    from fdt_torch.models import load_pyramidbox_detector

    n = torch.cuda.device_count()
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2) if n == 1 else make_mesh(n)
    path = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])
    det = load_pyramidbox_detector("try3", path, device="cuda:0")
    det_dp = load_pyramidbox_detector("try3", path, mesh=mesh)
    images = np.random.RandomState(8).randint(0, 256, (5, 128, 128, 3), dtype=np.uint8)
    record = {}
    with chip_smoke.k1_checked(record):
        got = det_dp.detect_tensor(images, conf_thresh=0.05)
    assert sorted(record) == sorted(str(d) for d in mesh.distinct)
    assert all(err == 0 for _, err in record.values())
    chip_smoke.check_dp_detections(got, det.detect_tensor(images, conf_thresh=0.05))


def _profiled(det, frames, calls):
    """`calls` detect_tensor calls of det (each given its keyword arguments)
    traced as the benchmark traces (portbench's Trace: the card's
    activities only): (the profiler, its Trace, the spans recorded, those
    spans placed by portbench's join)."""
    from fdt_torch.utils import trace
    from portbench.metrics import _spans
    from portbench.metrics._trace import Trace

    Trace.warm()
    trace.drain()
    tr = Trace()
    tr.start()
    prof = tr._prof
    for kw in calls:
        det.detect_tensor(frames, **kw)
    tr.stop()
    rec = trace.drain()
    return prof, tr, rec, _spans._place(tr, rec)


def _check_join(prof, rec, placed, images):
    """Placed spans within 20 µs of the exact placement (the profiler's own
    start on CLOCK_REALTIME)."""
    assert placed is not None and len(placed.spans) == len(rec.spans)
    assert placed.images == images
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    off_us = [(rec.to_real_ns(s.start_ns) - start_ns) / 1e3 - a
              for s, (a, _, _) in zip(rec.spans, placed.spans)]
    assert max(map(abs, off_us)) < 20, off_us


def test_profiled_detect_spans_hold_the_threads_launch_calls(try3_on_card):
    """detect_tensor's replays (the third call of a shape on): each records
    `detect` with `detect.upload`, `model.forward` and `detect.readback`
    under it (no `detect.head`: the graph holds its work), placed by
    portbench's join within 20 µs of the exact placement.  The stretch
    holds no kernel launch call at all; each graph launch starts inside
    `model.forward`, none inside `detect.readback`; the profiler records the
    graph's kernels, K1's among them."""
    import re

    from portbench.metrics import _spans

    names = ["detect", "detect.upload", "model.forward", "detect.readback"]
    frames = np.random.RandomState(3).randint(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    for _ in range(2):  # eager, then the capture
        try3_on_card.detect_tensor(frames)
    prof, tr, rec, placed = _profiled(try3_on_card, frames, [{}] * 3)
    assert [s.name for s in rec.spans] == names * 3
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    _check_join(prof, rec, placed, 12)
    assert _spans.launches_in(placed, set(names)) == (0, 0)
    graph_starts = [s for name, s, _ in tr.host if name.startswith("cudaGraphLaunch")]
    assert len(graph_starts) == 3
    forward = [(a, b) for a, b, n in placed.spans if n == "model.forward"]
    readback = [(a, b) for a, b, n in placed.spans if n == "detect.readback"]
    assert all(any(a <= t <= b for a, b in forward) for t in graph_starts)
    assert not any(a <= t <= b for a, b in readback for t in graph_starts)
    assert sum(bool(re.search(r"nms_\w+_kernel", n)) for n, _, _ in tr.ops) >= 3 * 3


def test_profiled_eager_detect_spans_hold_the_threads_launch_calls(try3_on_card):
    """Eager detect_tensor calls (each at thresholds not seen before)
    record their five spans; at least 99% of the launch calls start inside
    one of them and none inside `detect.readback`, which issues a copy
    alone."""
    from fdt_torch.infer import graphs
    from portbench.metrics import _spans

    names = ["detect", "detect.upload", "model.forward", "detect.head", "detect.readback"]
    frames = np.random.RandomState(3).randint(0, 256, (4, 256, 256, 3), dtype=np.uint8)
    try3_on_card.detect_tensor(frames, conf_thresh=0.01)
    eager = graphs.graph_eager.count
    prof, tr, rec, placed = _profiled(try3_on_card, frames,
                                      [{"conf_thresh": 0.02 + 0.01 * i} for i in range(3)])
    assert graphs.graph_eager.count == eager + 3
    assert [s.name for s in rec.spans] == names * 3
    assert {s.thread for s in rec.spans} == {threading.get_native_id()}
    _check_join(prof, rec, placed, 12)
    inside, total = _spans.launches_in(placed, set(names))
    assert total > 30 and inside >= 0.99 * total, (inside, total)
    assert _spans.launches_in(placed, {"detect.readback"})[0] == 0


# the benchmark's two detectors (portbench/configs/, portbench/traffic/):
# npz, batch, threshold, NMS threshold
BENCH_DETECTORS = {"repo": ("net_weight/repo_mini.npz", 8, 0.0, 0.35),
                   "try1": ("net_weight/try1_distilled_mini.npz", 32, 0.3, 0.3)}


def _bench_detector(variant, card):
    """The benchmark's detector of `variant`: bf16, channels-last, budget
    5000, top_k 750."""
    import dataclasses

    from fdt_torch.config import PYRAMID_CONFIGS
    from fdt_torch.models import load_pyramidbox_detector

    detect_cfg = dataclasses.replace(PYRAMID_CONFIGS[variant].detect, top_k=750)
    return load_pyramidbox_detector(variant, str(REPO / BENCH_DETECTORS[variant][0]),
                                    detect_cfg=detect_cfg, budget=5000,
                                    dtype=torch.bfloat16, device=card)


def _eager(det, images, conf, nms_thresh):
    """The eager path's answer (`_detect_on`, the graph's counterpart)."""
    x = torch.from_numpy(images)
    with torch.inference_mode():
        return det._detect_on(det.device, x, det._dcfg(x, conf, nms_thresh)).cpu().numpy()


def _graph_counts():
    from fdt_torch.infer import graphs

    return graphs.graph_eager.count, graphs.graph_captures.count, graphs.graph_replays.count


@pytest.mark.parametrize("variant", ["repo", "try1"])
def test_graph_replays_bit_equal_to_eager_on_the_bench_detectors(card, variant):
    """The bf16 flagship at 8 × 640² and try1 at 32 × 640², on the
    benchmark's weights, frames (portbench.generate, a large seed) and
    thresholds: detect_tensor's first call of the shape runs eagerly, its
    second captures, the next four replay, and every answer equals the
    eager path's bit for bit.  K1's launch counter moves at the eager call
    and at the capture (its warm-up on the side stream and the capture),
    never at a replay: K1 runs inside the graph."""
    from portbench import generate

    _, batch, conf, nms_thresh = BENCH_DETECTORS[variant]
    det = _bench_detector(variant, card)
    frames = generate.frames(2**31 + 23, 2 * batch, 640, 640).reshape(2, batch, 640, 640, 3)
    wants = [_eager(det, f, conf, nms_thresh) for f in frames]
    c0, k1 = _graph_counts(), nms_op.launches.count
    for i in range(6):
        got = det.detect_tensor(frames[i % 2], conf_thresh=conf, nms_thresh=nms_thresh)
        assert np.array_equal(got, wants[i % 2]), i
        if i == 1:
            assert nms_op.launches.count == k1 + 3
    assert nms_op.launches.count == k1 + 3
    assert tuple(a - b for a, b in zip(_graph_counts(), c0)) == (1, 1, 4)
    assert (wants[0][:, 1, :, 0] > 0).sum() > 0  # rows to compare


def test_graphs_sharing_a_pool_stay_bit_equal_through_alternation_and_eviction(
        card, monkeypatch):
    """try1 (bf16) at two shapes and two threshold pairs, four graphs on
    the detector's one memory pool, called in turn: every answer equals the
    eager path's bit for bit.  Then, the bound cut to 2, a fifth key's
    capture evicts three; the survivors, the evicted keys (eager, captured
    again into the same pool) and the new one still answer bit-equal."""
    from fdt_torch.infer import graphs

    det = _bench_detector("try1", card)
    rng = np.random.RandomState(5)
    batches = {(4, 320, 320): None, (2, 256, 384): None, (1, 320, 320): None}
    for shape in batches:
        batches[shape] = rng.randint(0, 256, (*shape, 3), dtype=np.uint8)
    pairs = [(0.3, 0.3), (0.1, 0.5)]
    keys = [(shape, pair) for shape in list(batches)[:2] for pair in pairs]
    wants = {(shape, pair): _eager(det, batches[shape], *pair)
             for shape in batches for pair in pairs}

    def call(key):
        shape, (conf, nms_thresh) = key
        got = det.detect_tensor(batches[shape], conf_thresh=conf, nms_thresh=nms_thresh)
        assert np.array_equal(got, wants[key]), key

    c0 = _graph_counts()
    for _ in range(3):
        for key in keys:
            call(key)
    assert tuple(a - b for a, b in zip(_graph_counts(), c0)) == (4, 4, 4)
    assert len(det._graphs.entries) == 4
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 2)
    fifth = ((1, 320, 320), pairs[0])
    for _ in range(2):
        call(fifth)
    assert len(det._graphs.entries) == 2
    for _ in range(3):
        for key in keys + [fifth]:
            call(key)
