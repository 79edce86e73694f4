"""Size-bucketed batched PyramidBox evaluation (counterpart of
fdt/eval/batched.py:34-96), the throughput path for WIDER val.

The reference evaluates one image at a time at native resolution.  This
module groups the eval images into (W, H) buckets, sides rounded up to a
multiple of 128, right/bottom-pads each image with the pixel mean to its
bucket (the priors are built for the padded size, so decoded coordinates
stay in true pixels; the padding is about zero after the mean subtraction),
and runs `detect_tensor` once per chunk of a bucket: one forward and one NMS
call (kernel K1 on the card) with a problem per image of the chunk.

Padding changes the convolutions' context near the seam, so scores there
differ slightly from the native protocol's.  An image already at its bucket
size is not padded, but it rides a batch of up to batch_size where the
native path runs batch 1, and a convolution of another batch size may sum
in another order (cuDNN picks its kernels by shape): its rows agree with
the native path's to that order, not bit for bit (float32 on an H100:
8.05e-07 in score, 1.5e-4 px at most).  Bit-faithful eval stays in
fdt_torch.eval.runner.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from fdt_torch.config import PIXEL_MEAN_BGR
from fdt_torch.data.collector import EvalCollector
from fdt_torch.data.image_io import image_size, imread
from fdt_torch.eval.pr import TfConfAccumulator
from fdt_torch.infer.pyramidbox import detections_to_rows


def bucket_for(w: int, h: int, multiple: int = 128) -> Tuple[int, int]:
    up = lambda v: ((v + multiple - 1) // multiple) * multiple  # noqa: E731
    return up(w), up(h)


def eval_pyramidbox_batched(detector, anno_file: str, threshold: float,
                            batch_size: int = 8, dump_path: str = "",
                            iou_thresh: float = 0.5,
                            progress: bool = True) -> np.ndarray:
    """Bucketed-batched PyramidBox eval; returns the reference-layout dump.
    The bucketing pass reads each image's size from its header alone."""
    dataset = EvalCollector(anno_file)
    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, rec in enumerate(dataset.records):
        buckets[bucket_for(*image_size(rec.path))].append(i)

    acc = TfConfAccumulator(iou_thresh)
    mean = np.array(PIXEL_MEAN_BGR, np.float32).astype(np.uint8)
    done = 0
    for (bw, bh), idxs in buckets.items():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            batch = np.zeros((len(chunk), bh, bw, 3), np.uint8)
            for j, i in enumerate(chunk):
                img = imread(dataset.records[i].path)
                if img is None:
                    raise FileNotFoundError(dataset.records[i].path)
                h, w, _ = img.shape
                batch[j] = mean
                batch[j, :h, :w] = img
            det = detector.detect_tensor(batch, conf_thresh=threshold,
                                         nms_thresh=0.35)
            for j, i in enumerate(chunk):
                # priors are normalized by the PADDED size → scale by it
                rows = detections_to_rows(det[j], threshold, [bw, bh, bw, bh])
                acc.add(rows, dataset.records[i].boxes_xywh)
                done += 1
            if progress:
                print(f"bucket {bw}x{bh}: {done} images done")
    dump = acc.finalize()
    if dump_path:
        np.save(dump_path, dump)
    return dump
