"""Replay saved tracks over a video's frames (counterpart of
scripts/track_display.py, the reference's iouTracke_display.py CLI, with the
same flags).

`video` is a directory of the video's frames; --out is a directory that
receives each rendered frame as a PNG (fdt's writes a video file).

  python -m fdt_torch.cli.track_display clip --out clip_tracks
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("video", help="directory of the video's frames")
    ap.add_argument("--tracks", default=None, help="defaults to <video>.npy")
    ap.add_argument("--out", default=None, help="output directory of PNG frames (headless)")
    ap.add_argument("--display", action="store_true")
    args = ap.parse_args(argv)

    from fdt_torch.cli.track_video import default_tracks_path
    from fdt_torch.data.frames import read_frames
    from fdt_torch.track import load_tracks
    from fdt_torch.track.display import render_tracks

    frames = read_frames(args.video)
    tracks = load_tracks(args.tracks or default_tracks_path(args.video))
    n = render_tracks(frames, tracks, out_dir=args.out, display=args.display)
    print(f"rendered {n} frames, {len(tracks)} tracks")


if __name__ == "__main__":
    main()
