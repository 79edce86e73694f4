"""The `batch` kind (portbench/entries/batch.py, run as it stands) for a
detector whose rows carry five landmarks after the box: [B, 2, top_k, 15]
detect outputs, [score, x1, y1, x2, y2, then x, y of each landmark].

Mix keys: batch's.  batch.run is driven with two of its module's names
swapped for the length of the call: `_rows`, so that each checked image's
rows keep their landmark columns ([m, 15] pixel rows: x1, y1, x2, y2,
score, then the ten coordinates), and `tracer`, whose Trace also reads the
program's graph-cache counters (fdt_torch.infer.graphs: graph_captures,
graph_replays, graph_eager) as the traced stretch starts and stops, into
`outcome.stats` (their increase over the stretch).  The notes gain
`landmark_rows`: the program's counter of faces returned with landmarks
(fdt_torch.infer.retinaface.landmark_rows), its increase over the run.

check(cell, outcome) gives portbench.check's row numbers on the boxes and
scores, and `landmark_gap_mean`: over the returned rows, each matched to the
prior whose reference box lies nearest (portbench.check's matching), the
mean of the largest gap of its ten landmark coordinates to that prior's
reference landmarks, in pixels over the reference box's longer side.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import check as rows_check
from portbench.entries import Outcome, batch
from portbench.metrics._trace import Trace

GRAPH_COUNTERS = ("graph_captures", "graph_replays", "graph_eager")


def _graph_counts() -> dict | None:
    """The program's graph-cache counters, or None where it has none."""
    try:
        from fdt_torch.infer import graphs
        return {name: getattr(graphs, name).count for name in GRAPH_COUNTERS}
    except (ImportError, AttributeError):
        return None


def _landmark_rows() -> int | None:
    try:
        from fdt_torch.infer.retinaface import landmark_rows
        return landmark_rows.count
    except ImportError:
        return None


class CountingTrace(Trace):
    """A Trace that also reads the graph-cache counters at its stretch's ends."""

    def __init__(self):
        super().__init__()
        self.graphs_at = {}

    def start(self) -> None:
        self.graphs_at["start"] = _graph_counts()
        super().start()

    def stop(self) -> None:
        if self.active:
            super().stop()
            self.graphs_at["stop"] = _graph_counts()

    def graph_stats(self) -> dict:
        a, b = self.graphs_at.get("start"), self.graphs_at.get("stop")
        return {} if a is None or b is None else {k: b[k] - a[k] for k in GRAPH_COUNTERS}


def _tracer(cell) -> CountingTrace | None:
    if not (cell.trace and cell.device.type == "cuda"):
        return None
    Trace.warm()
    return CountingTrace()


def _rows(det: np.ndarray, width: int, height: int) -> list[np.ndarray]:
    """[B, 2, top_k, 15] detect output → each image's [m, 15] pixel rows
    (the kept rows lead; zero rows follow)."""
    box = np.array([width, height] * 2, np.float32)
    points = np.array([width, height] * 5, np.float32)
    out = []
    for d in det[:, 1]:
        n = int(np.cumprod(d[:, 0] > 0).sum())
        out.append(np.column_stack([d[:n, 1:5] * box, d[:n, 0], d[:n, 5:15] * points])
                   .astype(np.float32))
    return out


@contextlib.contextmanager
def _swapped(module, **names):
    old = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def run(cell, detector=None) -> Outcome:
    rows_before = _landmark_rows()
    with _swapped(batch, _rows=_rows, tracer=_tracer):
        outcome = batch.run(cell, detector)
    if outcome.trace is not None:
        outcome.stats.update(outcome.trace.graph_stats())
    rows_after = _landmark_rows()
    if rows_before is not None:
        outcome.notes["landmark_rows"] = rows_after - rows_before
    return outcome


def landmark_gap(rows: np.ndarray, ref, device="cpu") -> np.ndarray:
    """Each row's largest landmark gap to its nearest prior's reference
    landmarks, over that reference box's longer side."""
    dev = torch.device(device)
    rows_t = torch.as_tensor(np.asarray(rows, np.float32), device=dev).reshape(-1, 15)
    boxes = torch.as_tensor(ref.boxes, device=dev)
    idx, _ = rows_check._nearest(rows_t[:, :4], boxes)
    side = (boxes[idx, 2:] - boxes[idx, :2]).amax(-1)
    gap = (rows_t[:, 5:] - torch.as_tensor(ref.landmarks, device=dev)[idx]).abs().amax(-1)
    return (gap / side).cpu().numpy()


def check(cell, outcome, ref=None) -> tuple[dict, list]:
    """({number: value}, the reference's results): portbench.check's numbers
    on each image's boxes and scores, and landmark_gap_mean."""
    results = (ref or cell.family.reference(cell))(outcome.frames, outcome.head)
    per_image = [rows_check.compare_image(rows[:, :5], r, outcome.head.nms_thresh, outcome.cut,
                                          outcome.head.top_k, cell.device)
                 for rows, r in zip(outcome.rows, results)]
    numbers = rows_check.summarize(per_image)
    gaps = np.concatenate([landmark_gap(rows, r, cell.device)
                           for rows, r in zip(outcome.rows, results)] + [np.zeros(0)])
    numbers["landmark_gap_mean"] = float(gaps.mean()) if len(gaps) else 0.0
    numbers["landmark_gap"] = float(gaps.max()) if len(gaps) else 0.0
    return numbers, results
