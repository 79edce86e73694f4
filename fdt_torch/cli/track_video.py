"""Offline multi-face IoU tracking over a video's frames (counterpart of
scripts/track_video.py, the reference's iouTracke_cal.py CLI, with the same
flags).

The port decodes no video: `video` is a directory of its frames, read in
sorted name order.  Saves the reference's track format (<video>.npy beside
the directory unless --out); replay with python -m fdt_torch.cli.track_display.

  ffmpeg -i clip.mp4 clip/%06d.png
  python -m fdt_torch.cli.track_video clip --net repo \
      --weights net_weight/repo_mini.npz
"""
from __future__ import annotations

import argparse

from fdt_torch.cli._common import add_device_flag


def default_tracks_path(video: str) -> str:
    """<video stem>.npy, as scripts/track_video.py names it; for a frame
    directory, its name with .npy."""
    return video.rstrip("/").rsplit(".", 1)[0] + ".npy"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("video", help="directory of the video's frames (the port decodes no "
                                  "video file)")
    ap.add_argument("--net", default="repo")
    ap.add_argument("--weights", default=None, help="variables npz or torch .pth")
    ap.add_argument("--batch", default=8, type=int)
    ap.add_argument("--out", default=None, help="defaults to <video>.npy")
    ap.add_argument("--device_tracker", action="store_true",
                    help="run the greedy association on the device (kernel K3)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from fdt_torch.data.frames import read_frames
    from fdt_torch.models.loader import load_pyramidbox_detector
    from fdt_torch.track import save_tracks, track_video

    frames = read_frames(args.video)
    det = load_pyramidbox_detector(args.net, args.weights, device=args.device)
    tracks = track_video(frames, det, batch_size=args.batch,
                         device_tracker=args.device_tracker)
    out = args.out or default_tracks_path(args.video)
    save_tracks(tracks, out)
    print(f"{len(tracks)} tracks saved to {out}")


if __name__ == "__main__":
    main()
