"""Video frames from a directory of images, in place of cv2.VideoCapture.

The port decodes no video: it does not use cv2, whose VideoCapture fdt
reads video with, and depends on no other video decoder.  So the video
paths take frames, and the CLIs read them from a directory of image files (for example written by
`ffmpeg -i video.mp4 frames/%06d.png`), decoded by image_io.imread.
"""
from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

from fdt_torch.data.image_io import imread

# file suffixes read as frames; other files in the directory are skipped
FRAME_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".webp")
NO_DECODER = ("the port has no video decoder (it does not use cv2.VideoCapture, "
              "and depends on no other)")


def read_frames(path) -> Iterator[np.ndarray]:
    """BGR uint8 [H, W, 3] frames of a directory of images, in sorted name
    order, as cv2.VideoCapture yields a video's; other files are skipped.  A
    camera index or a video file raises ValueError at once, naming the
    missing decoder; an image file that does not decode raises ValueError
    when its turn comes."""
    if isinstance(path, int) or str(path).isdigit():
        raise ValueError(f"camera {path}: {NO_DECODER}; give a directory of frames")
    directory = pathlib.Path(path)
    if not directory.is_dir():
        raise ValueError(f"{path}: not a directory of frames; {NO_DECODER}, so a video "
                         "file must first be cut into images (e.g. ffmpeg -i "
                         "video.mp4 frames/%06d.png)")
    paths = sorted(p for p in directory.iterdir()
                   if p.is_file() and p.suffix.lower() in FRAME_SUFFIXES)

    def frames():
        for p in paths:
            image = imread(p)
            if image is None:
                raise ValueError(f"{p}: not a decodable image")
            yield image
    return frames()


def fit_frame(frame: np.ndarray, frame_size) -> np.ndarray:
    """cv2.resize(frame, frame_size) of a BGR uint8 frame: the frame itself
    when it already has that (width, height), since cv2's resize to the same
    size is a copy, else resize_bilinear (within 1 LSB of cv2's)."""
    width, height = frame_size
    if frame.shape[:2] == (height, width):
        return frame
    from fdt_torch.apps.serving import resize_bilinear
    return resize_bilinear(frame, width, height)
