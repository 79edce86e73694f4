"""The configuration's detector (`detect_tensor`) in a closed loop of
batches from host memory; the rows come back to the host each call.

Mix keys: width, height, batch, distinct_batches (the batches the seed
makes, sent in turn), threshold, nms_thresh, check_batches (how many of the
distinct batches are compared, drawn from the seed)."""
from __future__ import annotations

import time

import numpy as np

from portbench import generate
from portbench.entries import TRACE_S, TRACE_START, WARMUP_S, Outcome, head, peak, ready, tracer


def _rows(det: np.ndarray, width: int, height: int) -> list[np.ndarray]:
    """[B, 2, top_k, 5] detect output → each image's face rows in pixels,
    [x1, y1, x2, y2, score] (the kept rows lead; zero rows follow)."""
    scale = np.array([width, height, width, height], np.float32)
    out = []
    for d in det[:, 1]:
        n = int(np.cumprod(d[:, 0] > 0).sum())
        out.append(np.column_stack([d[:n, 1:5] * scale, d[:n, 0]]).astype(np.float32))
    return out


def run(cell, detector=None) -> Outcome:
    t = cell.traffic
    w, h, b, distinct = t["width"], t["height"], t["batch"], t["distinct_batches"]
    det = detector or cell.family.build(cell)
    pool = generate.frames(cell.seed, distinct * b, h, w).reshape(distinct, b, h, w, 3)
    call = lambda k: det.detect_tensor(pool[k % distinct], conf_thresh=t["threshold"],  # noqa: E731
                                       nms_thresh=t["nms_thresh"])
    warm_end = time.perf_counter() + WARMUP_S
    for k in range(3):
        call(k)
    while time.perf_counter() < warm_end:
        call(0)
    trace = tracer(cell)
    setup_s = ready(cell)

    check_ids = generate.sample(cell.seed, distinct, t["check_batches"]).tolist()
    last, traced_id, untraced = {}, None, None
    failed_batches = done = k = 0
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    while (now := time.perf_counter()) < end:
        if trace and traced_id is None and now - t0 >= cell.seconds * TRACE_START:
            untraced = done * b / (now - t0)
            traced_id = k % distinct
            trace.start()
        try:
            out = call(k)
            done += 1
            if k % distinct in check_ids or (k % distinct == traced_id and not trace.batches):
                last[k % distinct] = out
        except Exception:  # noqa: BLE001 — a failed batch
            failed_batches += 1
        if trace and trace.active:
            trace.batches += 1
            if trace.elapsed_s() >= TRACE_S:
                trace.stop()
        k += 1
    window_s = time.perf_counter() - t0
    notes = {"batches": k, "window_s": window_s}
    if trace:
        trace.stop()
        trace.images = trace.batches * b
        # the profiler's cost: the traced stretch's rate against the rate before it
        notes.update(untraced_images_per_s=untraced,
                     traced_images_per_s=trace.images / trace.window_s if trace.window_s else None)
    if traced_id is not None and traced_id not in check_ids:
        check_ids.append(traced_id)
    ids = [i for i in check_ids if i in last]
    rows = [r for i in ids for r in _rows(last[i], w, h)]
    traced = []
    if traced_id in ids:
        at = ids.index(traced_id) * b
        traced = list(range(at, at + b))
    return Outcome(attempted=k * b, failed=failed_batches * b,
                   metrics={"images_per_s": done * b / window_s, "setup_s": setup_s},
                   frames=pool[ids].reshape(-1, h, w, 3), rows=rows, head=head(cell),
                   cut=t["threshold"], memory_peak_bytes=peak(cell), trace=trace,
                   traced=traced, untraced_images_per_s=untraced,
                   notes=notes)
