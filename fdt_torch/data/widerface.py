"""WIDER-FACE training dataset: anno parsing + augmentation + batching
(counterpart of fdt/data/widerface.py).

A shuffled epoch iterator producing (images [B,S,S,3] float32 NHWC, targets
list) batches ready for fdt_torch.train.pad_targets and the upload to the
card.  Images are read by fdt_torch.data.image_io.imread (Pillow) where fdt
calls cv2.imread: a JPEG may decode a few levels apart, a PNG bit-equal.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import numpy as np

from fdt_torch.data.anno import parse_anno_file
from fdt_torch.data.image_io import imread


def annotation_transform(boxes_xywh: np.ndarray, width: int, height: int) -> np.ndarray:
    """xywh int boxes → normalized [x1,y1,x2,y2,label(=0)] rows.

    Replicates AnnotationTransform (data/widerface.py:36-64): zero-size boxes
    dropped; negative width/height swaps the corresponding min/max.
    """
    res = []
    for x, y, w, h in boxes_xywh:
        if w == 0 or h == 0:
            continue
        xmin, ymin, xmax, ymax = x, y, x + w, y + h
        if w < 0:
            xmin, xmax = xmax, xmin
        elif h < 0:
            ymin, ymax = ymax, ymin
        res.append([xmin / float(width), ymin / float(height),
                    xmax / float(width), ymax / float(height), 0.0])
    return np.array(res, np.float32).reshape(-1, 5)


class WiderFaceDataset:
    """Training dataset with augmentation (Detection, data/widerface.py:67-117)."""

    def __init__(self, anno_file: str, size: int = 640,
                 augment: Callable | None = None,
                 rng: np.random.RandomState | None = None):
        from fdt_torch.data.augment import pyramid_augment
        records = parse_anno_file(anno_file)
        # drop records whose every box is zero-sized (the shipped
        # gen_anno_file_train carries 4 such '0 0 0 0' lines — the degenerate
        # entries gen_anno.py's validator flags): annotation_transform would
        # leave them with zero GT and the data-anchor crop has no face to
        # sample (the reference crashes on them the same way,
        # augmentations.py:292)
        self.records = [r for r in records
                        if np.any((r.boxes_xywh[:, 2] != 0)
                                  & (r.boxes_xywh[:, 3] != 0))]
        self.size = size
        self.rng = rng or np.random.RandomState(0)
        self.augment = augment or pyramid_augment

    def __len__(self) -> int:
        return len(self.records)

    def pull_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (image [S,S,3] float32, target [n,5] normalized boxes+labels)."""
        rec = self.records[index]
        img = imread(rec.path)
        if img is None:
            raise FileNotFoundError(rec.path)
        height, width, _ = img.shape
        target = annotation_transform(rec.boxes_xywh, width, height)
        img, boxes, labels = self.augment(img, target[:, :4], target[:, 4],
                                          self.rng, self.size)
        return img, np.hstack((boxes, labels[:, None]))

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Tuple[np.ndarray, List[np.ndarray]]]:
        """One epoch of (stacked images, per-image target list) batches
        (detection_collate semantics, data/widerface.py:120-137)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        n_full = len(order) // batch_size
        end = n_full * batch_size if drop_last else len(order)
        for s in range(0, end, batch_size):
            idx = order[s:s + batch_size]
            items = [self.pull_item(int(i)) for i in idx]
            images = np.stack([im for im, _ in items])
            targets = [t for _, t in items]
            yield images, targets
