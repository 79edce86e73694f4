"""Track playback renderer (counterpart of fdt/track/display.py).

Replays saved tracks over the frames (iouTracke_display.py:18-80): each track
takes a random colour at its start frame, its current box is drawn on the
frame and the trace of its centre on a drawboard that persists, and the
drawboard is laid over the frame through a threshold mask.  Headless: writes
each frame as a PNG instead of a video.

Differences from fdt, which draws with cv2:
  * frames come in as an iterable (the port decodes no video);
  * lines and rectangles are drawn by Pillow's ImageDraw, so thick lines
    differ from cv2's in their pixels;
  * a track's hue is drawn from 0..359 and taken modulo 256 before cv2's
    8-bit HSV→BGR (`_track_colour`), which is what the reference computed
    under NumPy 1.x; fdt's np.uint8([[(hue, 255, 255)]]) raises
    OverflowError under NumPy 2 for a hue of 256 or more.
The mask and the overlay (`_composite`) are cv2's arithmetic, exactly.
"""
from __future__ import annotations

import os

import numpy as np

# cv2's HSV→RGB sector table (color_hsv.simd.hpp): the indices into
# (v, v(1 - s), v(1 - s h), v(1 - s(1 - h))) of blue, green and red
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _track_colour(hue: int) -> list[int]:
    """cv2.cvtColor(np.uint8([[(hue % 256, 255, 255)]]), cv2.COLOR_HSV2BGR)
    [0, 0].tolist(): 8-bit HSV with H in 0..179 (a larger H wraps past 180),
    S = V = 255, in the float32 arithmetic of cv2's scalar HSV2RGB_native,
    the one a 1-pixel image takes: v(1 - s(1 - h)) is not rounded as h."""
    one, six = np.float32(1), np.float32(6)
    h = np.float32(hue % 256) * (six / np.float32(180))
    while h >= six:
        h -= six
    sector = int(np.floor(h))
    h -= np.float32(sector)
    tab = np.array([one, 0, one - h, one - (one - h)], np.float32)
    return [int(np.rint(tab[i] * np.float32(255))) for i in _SECTORS[sector]]


def _composite(image: np.ndarray, drawboard: np.ndarray) -> np.ndarray:
    """The drawboard over the frame, as cv2 computes it: mask = 255 where
    cvtColor(drawboard, BGR2GRAY) <= 1 (threshold(1, 255, THRESH_BINARY_INV)),
    bitwise_and(image, image, mask=mask), then the saturating add of the
    drawboard.  Gray is cv2's 15-bit fixed point: (3735 B + 19235 G + 9798 R
    + 2^14) >> 15."""
    board = drawboard.astype(np.int32)
    gray = (board[..., 0] * 3735 + board[..., 1] * 19235 + board[..., 2] * 9798
            + (1 << 14)) >> 15
    kept = np.where((gray <= 1)[..., None], image, 0).astype(np.int32)
    return np.minimum(kept + board, 255).astype(np.uint8)


def render_tracks(frames, tracks, out_dir: str | None = None, dis_width: int = 800,
                  rng: np.random.RandomState | None = None,
                  max_frames: int | None = None, display: bool = False) -> int:
    """Draw `tracks` (the IoU tracker's schema, boxes in 640×480 pixels) over
    `frames` (BGR uint8), each shown at dis_width wide; write each frame as
    `out_dir/<frame number, 6 digits>.png` when out_dir is given, and show it
    in a window with display=True (refused where no display server is
    named).  Returns the number of frames rendered."""
    from PIL import Image, ImageDraw

    from fdt_torch.data.frames import fit_frame

    window = None
    if display:
        from fdt_torch.apps.video import FrameWindow
        window = FrameWindow("tracks")
    rng = rng or np.random.RandomState()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    tracks = [dict(t) for t in tracks]
    active = []
    board = draw_board = None
    frame_num = 0
    for image in frames:
        if max_frames is not None and frame_num >= max_frames:
            break
        if board is None:  # the first frame sets the display size
            oh, ow = image.shape[:2]
            fw, fh = dis_width, int(oh * dis_width / ow)
            w_ratio, h_ratio = fw / 640, fh / 480
            board = Image.new("RGB", (fw, fh))  # BGR bytes, as drawn
            draw_board = ImageDraw.Draw(board)
        frame_num += 1
        frame = Image.fromarray(np.ascontiguousarray(fit_frame(image, (fw, fh))))
        draw = ImageDraw.Draw(frame)
        for track in tracks:
            if track["start_frame"] == frame_num:
                track["color"] = _track_colour(rng.randint(0, 360))
                active.append(track)
        for track in list(active):
            idx = frame_num - track["start_frame"]
            if idx >= len(track["bboxes"]):
                active.remove(track)
            elif idx > 0:
                x10, y10, x20, y20 = track["bboxes"][idx - 1]
                x11, y11, x21, y21 = track["bboxes"][idx]
                c0 = (int(w_ratio * (x10 + x20) / 2), int(h_ratio * (y10 + y20) / 2))
                c1 = (int(w_ratio * (x11 + x21) / 2), int(h_ratio * (y11 + y21) / 2))
                pt1 = (int(w_ratio * x11), int(h_ratio * y11))
                pt2 = (int(w_ratio * x21), int(h_ratio * y21))
                thickness = int((x21 + y21 - y11 - x11) / 80) + 1
                colour = tuple(track["color"])
                draw_board.line([c0, c1], fill=colour, width=thickness)
                draw.rectangle([min(pt1[0], pt2[0]), min(pt1[1], pt2[1]),
                                max(pt1[0], pt2[0]), max(pt1[1], pt2[1])], outline=colour)
        out = _composite(np.asarray(frame), np.asarray(board))
        if out_dir:
            Image.fromarray(out[:, :, ::-1]).save(os.path.join(out_dir, f"{frame_num:06d}.png"),
                                                  compress_level=1)
        if window is not None and not window.show(out):
            break
    return frame_num
