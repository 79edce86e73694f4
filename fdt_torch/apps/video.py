"""Video detection demos for the three detector families (counterpart of
fdt/apps/video.py).

The reference's webcam loops (Video.py:106-129, FACEBOX/Video.py:56-78,
MTCNN/Video.py:53-74) as library functions: per-frame detect, then a box,
score and fps overlay.  Where fdt captures from a camera or a video file
with cv2, the port takes an iterable of BGR frames (fdt_torch.data.frames
reads a directory of them): it decodes no video.  Headless, it writes each
overlaid frame as a PNG; display=True shows them in a matplotlib window
where a display server is named.  The overlay is drawn by Pillow (fdt: cv2),
so its pixels are not fdt's.
"""
from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np

RED = (0, 0, 255)  # BGR, as the frames


class FrameWindow:
    """The port's cv2.imshow: BGR frames shown in a matplotlib window, each
    for `pause_s`; Esc closes it.  Refused where no display server is
    named."""

    def __init__(self, title: str, pause_s: float = 0.04):
        from fdt_torch.eval.runner import _has_display
        if not _has_display():
            raise RuntimeError("display=True needs a display server (no DISPLAY or "
                               "WAYLAND_DISPLAY); pass out_dir= to write the frames "
                               "instead")
        import matplotlib.pyplot as plt
        self.plt, self.pause_s, self.open, self.image = plt, pause_s, True, None
        self.fig = plt.figure(title)
        self.fig.canvas.mpl_connect("key_press_event", self._key)

    def _key(self, event):
        if event.key == "escape":
            self.open = False

    def show(self, frame: np.ndarray) -> bool:
        """Show one BGR frame; False once Esc was pressed."""
        rgb = frame[:, :, ::-1]
        if self.image is None:
            self.image = self.fig.gca().imshow(rgb)
        else:
            self.image.set_data(rgb)
        self.plt.pause(self.pause_s)
        return self.open


def _overlay(frame: np.ndarray, rows, fps: float, landmarks=None) -> np.ndarray:
    """Boxes with their scores, landmarks and the fps over a BGR frame (a new
    array)."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.ascontiguousarray(frame))
    draw = ImageDraw.Draw(img)  # colours in BGR order, as the frame's bytes
    for box in rows:
        b = np.asarray(box[:4]).astype(np.int32).tolist()
        draw.rectangle([min(b[0], b[2]), min(b[1], b[3]), max(b[0], b[2]), max(b[1], b[3])],
                       outline=RED)
        draw.text((b[0], b[1] - 10), f"{box[4]:.3f}", fill=RED)
    if landmarks is not None:
        for lm in landmarks:
            for k in range(0, 10, 2):
                x, y = int(lm[k]), int(lm[k + 1])
                draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=(0, 255, 0))
    draw.text((5, 5), f"fps: {fps:.1f}", fill=(255, 255, 255))
    return np.asarray(img).copy()


def run_video(detect_fn: Callable[[np.ndarray], tuple], frames, frame_size=(640, 480),
              out_dir: str | None = None, display: bool = False,
              max_frames: int | None = None) -> float:
    """Generic demo loop over BGR frames; detect_fn(frame) → ([N, 5] rows,
    landmarks or None).  Each frame is fitted to `frame_size` (width, height)
    as cv2.resize fits it; the overlaid frames go to `out_dir/<n>.png`.
    Returns the average fps of detect_fn."""
    from fdt_torch.data.frames import fit_frame

    window = FrameWindow("fdt", pause_s=0.001) if display else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n, t_total = 0, 0.0
    for frame in frames:
        if max_frames is not None and n >= max_frames:
            break
        frame = fit_frame(frame, frame_size)
        t0 = time.perf_counter()
        rows, landmarks = detect_fn(frame)
        dt = time.perf_counter() - t0
        n += 1
        t_total += dt
        frame = _overlay(frame, rows, 1.0 / max(dt, 1e-6), landmarks)
        if out_dir:
            from PIL import Image
            Image.fromarray(frame[:, :, ::-1]).save(os.path.join(out_dir, f"{n:06d}.png"),
                                                    compress_level=1)
        if window is not None and not window.show(frame):
            break
    return n / t_total if t_total else 0.0


def pyramidbox_demo(detector, threshold: float = 0.4, **kw) -> float:
    """Video.py:106-129 (PyramidBox at 640×480); **kw go to run_video."""
    def detect(frame):
        return detector.detect_face(frame, threshold, nms_thresh=0.35), None
    return run_video(detect, **kw)


def facebox_demo(detector, **kw) -> float:
    """FACEBOX/Video.py; **kw go to run_video."""
    def detect(frame):
        boxes, probs = detector.detect(frame)
        rows = np.column_stack([boxes, probs]) if len(probs) else np.empty((0, 5))
        return rows, None
    return run_video(detect, **kw)


def mtcnn_demo(detector, **kw) -> float:
    """MTCNN/Video.py (boxes and 5-point landmarks) with either cascade, the
    host MTCNNDetector or the MTCNNDeviceCascade; **kw go to run_video."""
    def detect(frame):
        boxes, landmarks = detector.detect_face(frame)
        if not boxes.size:
            return np.empty((0, 5)), None
        return boxes, landmarks
    return run_video(detect, **kw)
