"""WIDER-FACE annotation tooling (a copy of fdt/data/anno.py, which imports
no JAX; the port imports nothing of fdt).

Converts the official `wider_face_{train,val}_bbx_gt.txt` into the one-line-per-
image format consumed by the datasets (`<path> <N> x y w h x y w h …`) and
parses/validates those files.  Reference: image_and_anno/anno/gen_anno.py:10-58.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class AnnoRecord:
    path: str
    boxes_xywh: np.ndarray  # [N, 4] int32 (x, y, w, h)


def generate_anno_file(bbx_gt_path: str, img_dir: str, out_path: str) -> int:
    """wider_face_*_bbx_gt.txt → gen_anno_file format; returns #images written.

    Mirrors gen_anno.py:13-38 exactly (WIDER zero-face images are annotated with
    box_num ≥ 1 and an all-zero box, which the validator flags for manual fixup
    per the reference README).
    """
    n = 0
    with open(bbx_gt_path) as f, open(out_path, "w") as out:
        line = f.readline()
        while line:
            name = line.strip()
            if not name.endswith(".jpg"):
                raise ValueError(f"malformed bbx_gt file near: {line!r}")
            img_path = os.path.join(img_dir, name)
            box_num = int(f.readline())
            cells: List[str] = []
            for _ in range(box_num):
                cells += f.readline().split(" ")[:4]
            out.write(f"{img_path} {box_num} {' '.join(cells)}\n")
            n += 1
            line = f.readline()
    return n


def parse_anno_file(anno_path: str) -> List[AnnoRecord]:
    """gen_anno_file → records (utils/data_collector.py:19-26 parsing)."""
    records = []
    with open(anno_path) as f:
        for line in f:
            cells = line.strip().split()
            num = int(cells[1])
            boxes = np.array(cells[2:2 + num * 4], dtype=np.int32).reshape(num, 4)
            records.append(AnnoRecord(path=cells[0], boxes_xywh=boxes))
    return records


def validate_anno_file(anno_path: str) -> List[str]:
    """Lint pass over a gen_anno_file (gen_anno.py:40-58); returns messages."""
    problems = []
    with open(anno_path) as f:
        for i, line in enumerate(f, start=1):
            cells = line.strip().split(" ")
            ok = (cells[0].endswith(".jpg") and int(cells[1]) >= 1
                  and [int(v) for v in cells[2:6]] != [0, 0, 0, 0])
            if not ok:
                problems.append(f"100 error in line: {i}")
            elif (len(cells) - 2) % 4 != 0:
                problems.append(f"%4 error in line: {i}")
    return problems
