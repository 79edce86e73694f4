"""WIDER-FACE evaluation loops for the three detector families (counterpart
of fdt/eval/runner.py).

The My_test.py / FACEBOX/My_test_facebox.py / MTCNN/My_test_mtcnn.py loops
as library functions: iterate the eval collector, detect per image,
accumulate TF/confidence pairs, and write the reference-layout
`data_of_<name>.npy` dump.  The annotated images of `display_dir` are drawn
with Pillow (fdt draws with cv2), so their pixels are not fdt's.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from fdt_torch.data.collector import EvalCollector
from fdt_torch.eval.pr import TfConfAccumulator, save_raw_part


def _draw(image, target_xywh, predict):
    """GT-green / pred-red overlay with each prediction's score
    (My_test.py:144-161), as an RGB Pillow image."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.ascontiguousarray(image[:, :, ::-1]))
    draw = ImageDraw.Draw(img)
    for x, y, w, h in np.asarray(target_xywh).tolist():
        draw.rectangle([x, y, x + w, y + h], outline=(0, 255, 0))
    for box in predict:
        b = box[:4].astype(np.int32).tolist()
        draw.rectangle([b[0], b[1], max(b[0], b[2]), max(b[1], b[3])], outline=(255, 0, 0))
        draw.text((b[0], b[1] - 10), f"{box[4]:.3f}", fill=(255, 0, 0))
    return img


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class _LiveWindow:
    """The reference's live window: each image for one second; the 's' key
    saves the image shown (My_test.py:144-161).  Drawn by matplotlib."""

    def __init__(self, snapshot_dir: str, snapshot_prefix: str):
        import matplotlib.pyplot as plt
        self.plt, self.dir, self.prefix, self.saved = plt, snapshot_dir, snapshot_prefix, 0
        self.fig = plt.figure("1")
        self.shown = None
        self.fig.canvas.mpl_connect("key_press_event", self._key)

    def _key(self, event):
        if event.key == "s" and self.shown is not None:
            path = os.path.join(self.dir, f"{self.prefix}_{self.saved}.jpg")
            self.shown.save(path)
            print(f"image saved in {self.dir}")
            self.saved += 1

    def show(self, img) -> None:
        self.shown = img
        self.fig.clf()
        self.fig.gca().imshow(np.asarray(img))
        self.plt.pause(1.0)


def _run(detect_fn, anno_file: str, dump_path: str, iou_thresh: float = 0.5,
         skip_ids: Sequence[int] = (), display_dir: str | None = None,
         display: bool = False, snapshot_dir: str = ".",
         snapshot_prefix: str = "eval", progress: bool = True,
         limit: int | None = None, process_index: int | None = None,
         process_count: int | None = None) -> np.ndarray:
    """display=True opens the reference's live GT-green/pred-red window with
    the 's'-key snapshot writer (refused where there is no display server);
    display_dir writes the same overlay per image headlessly instead.

    process_index/process_count shard the record list into contiguous
    blocks (one process per shard).  The dump written then is a RAW .npz
    part file (`<dump_path>.part<i>_of_<n>.npz`); merging the parts in
    process order (fdt_torch.eval.pr.merge_part_files, `python -m
    fdt_torch.cli.merge_eval`) reproduces the unsharded dump bit for bit,
    tied confidences included."""
    if (process_index is None) != (process_count is None):
        raise ValueError("process_index and process_count must be passed "
                         "together (one alone would either crash in the "
                         "collector or silently run the full unsharded eval)")
    if display and not _has_display():
        raise RuntimeError("display=True needs a display server (no DISPLAY or "
                           "WAYLAND_DISPLAY); pass display_dir= to write the "
                           "annotated images instead")
    acc = TfConfAccumulator(iou_thresh)
    dataset = EvalCollector(anno_file, process_index, process_count)
    window = _LiveWindow(snapshot_dir, snapshot_prefix) if display else None
    for image, target, img_id in dataset:
        if img_id in skip_ids:
            continue
        if limit is not None and img_id > limit:
            break
        if progress:
            print(f"testing image {img_id}...")
        predict = detect_fn(image)
        if display_dir or window:
            shown = _draw(image, target, predict)
            if display_dir:
                shown.save(os.path.join(display_dir, f"{img_id}.jpg"))
            if window:
                window.show(shown)
        acc.add(predict, target)
    dump = acc.finalize()
    if dump_path:
        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        if process_count and process_count > 1:
            base = dump_path[:-4] if dump_path.endswith(".npy") else dump_path
            save_raw_part(acc.raw(),
                          f"{base}.part{process_index}_of_{process_count}.npz")
        else:
            np.save(dump_path, dump)
    return dump


def eval_pyramidbox(detector, anno_file: str, threshold: float,
                    dump_path: str = "", **kw) -> np.ndarray:
    """My_test.py protocol: per-image native-resolution detection; rows are the
    prefix-walk of the [2,750,5] tensor (incl. sentinel), NMS 0.35."""
    def detect(image):
        return detector.detect_face(image, threshold)
    return _run(detect, anno_file, dump_path, **kw)


def eval_facebox(detector, anno_file: str, dump_path: str = "", **kw) -> np.ndarray:
    """FACEBOX/My_test_facebox.py protocol: 1024² resize, the detector's
    thresholds, boxes scaled back to the native resolution; empty prediction
    allowed."""
    def detect(image):
        boxes, probs = detector.detect(image)
        if len(probs) == 0:
            return np.empty((0, 5))
        return np.column_stack([boxes, probs])
    return _run(detect, anno_file, dump_path, **kw)


def eval_mtcnn(detector, anno_file: str, dump_path: str = "",
               skip_ids: Sequence[int] = (2852,), bucketed: bool = False,
               saturate_fallback=None, **kw) -> np.ndarray:
    """MTCNN/My_test_mtcnn.py protocol (min_face 24 detector, image 2852 skipped).

    bucketed=True routes through the device cascade's pad-to-bucket mode
    (MTCNNDeviceCascade.detect_face_bucketed): images of many sizes share a
    few canvas shapes.

    When the cascade reports budget saturation on an image (a fixed candidate
    cap may have truncated what the reference's unbounded lists would carry),
    a warning is emitted; pass any detector with detect_face as
    `saturate_fallback` to re-detect that image through it instead."""
    if bucketed:
        if not hasattr(detector, "detect_face_bucketed"):
            raise ValueError(
                "bucketed=True requires MTCNNDeviceCascade "
                f"({type(detector).__name__} has no detect_face_bucketed)")
        fn = detector.detect_face_bucketed
    else:
        fn = detector.detect_face

    def detect(image):
        boxes, _ = fn(image)
        if getattr(detector, "last_saturated", False):
            import warnings
            if saturate_fallback is not None:
                warnings.warn("device-cascade budget saturated; falling back "
                              "to saturate_fallback for this image")
                boxes, _ = saturate_fallback.detect_face(image)
            else:
                warnings.warn("device-cascade budget saturated on an image; "
                              "detections may be truncated (pass "
                              "saturate_fallback= to re-run it through "
                              "another detector)")
        return boxes if boxes.size else np.empty((0, 5))
    return _run(detect, anno_file, dump_path, skip_ids=skip_ids, **kw)
