"""Evaluation data iterator (counterpart of fdt/data/collector.py).

Yields (BGR image, [N,4] int32 xywh target, 1-based img_id) at native
resolution with no transform; images are read with
fdt_torch.data.image_io.imread in place of cv2.imread.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from fdt_torch.data.anno import parse_anno_file
from fdt_torch.data.image_io import imread


class EvalCollector:
    def __init__(self, anno_file: str, process_index: int | None = None,
                 process_count: int | None = None):
        """Optional multi-process sharding: each process takes a CONTIGUOUS
        block of the record list.  Blocks, not strides, so that concatenating
        per-process dumps in process order keeps the unsharded accumulation
        order; fdt_torch.eval.pr.merge_raw then reproduces the
        single-process dump bit for bit."""
        self.records = parse_anno_file(anno_file)
        self.start_id = 0
        if process_count and process_count > 1:
            n = len(self.records)
            lo = process_index * n // process_count
            hi = (process_index + 1) * n // process_count
            self.records = self.records[lo:hi]
            self.start_id = lo

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        for i, rec in enumerate(self.records):
            img = imread(rec.path)
            if img is None:
                raise FileNotFoundError(rec.path)
            # img_id stays GLOBAL under sharding: skip_ids, limit and display
            # file names keep their whole-dataset meaning
            yield img, rec.boxes_xywh, self.start_id + i + 1
