"""The configuration's detector behind fdt_torch.apps.serving.DetectionService
under open-loop arrivals: one thread submits each request at its due time;
a request's latency runs from its due time to the moment its future
resolves (the service's worker thread sets it).

Mix keys: width, height (the frames, sent without resize), rate_per_s,
frames (distinct frames the seed makes), threshold, nms_thresh, max_batch,
max_wait_ms (the service's), check_requests (how many answered requests
are compared, drawn from the seed; the slowest is always added).

Before the window, WARM_S seconds of the cell's own traffic bring the
service to a steady state, unmeasured.  A traced run profiles the window's
last TRACE_S seconds; the profiler starts and stops on the service's worker
thread, between batches."""
from __future__ import annotations

import functools
import threading
import time

import numpy as np

from portbench import generate
from portbench.entries import GRACE_S, TRACE_S, Outcome, head, peak, ready
from portbench.metrics._trace import Trace

WARM_S = 3.0


def offer(service, frames, due, pick, trace_at=None, start_trace=None):
    """Submit request i at t0 + due[i] (open loop); call start_trace() at
    the first request due at or after `trace_at`.  Returns (futures, t0,
    each request's lateness in s, each answer's time, NaN until it comes)."""
    done = np.full(len(due), np.nan)
    lock = threading.Lock()

    def stamp(i, fut):
        with lock:
            done[i] = time.perf_counter()

    futures, late = [], np.zeros(len(due))
    t0 = time.perf_counter() + 0.01
    for i, d in enumerate(due):
        if start_trace is not None and d >= trace_at:
            start_trace()
            start_trace = None
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - (t0 + d)
        fut = service.submit(frames[pick[i]])
        fut.add_done_callback(functools.partial(stamp, i))
        futures.append(fut)
    return futures, t0, late, done


def run(cell, detector=None) -> Outcome:
    from fdt_torch.apps.serving import DetectionService

    t = cell.traffic
    w, h = t["width"], t["height"]
    det = detector or cell.family.build(cell)
    service = DetectionService(cell.family.SERVICE, det, frame_size=(w, h),
                               threshold=t["threshold"], nms_thresh=t["nms_thresh"],
                               max_batch=t["max_batch"], max_wait_ms=t["max_wait_ms"])
    try:
        service.warmup()
        frames = generate.frames(cell.seed, t["frames"], h, w)
        if WARM_S:
            warm = generate.arrivals(cell.seed, t["rate_per_s"], WARM_S)
            for fut in offer(service, frames, warm,
                             generate.picks(cell.seed, len(warm), t["frames"]))[0]:
                fut.result(timeout=GRACE_S)
        due = generate.arrivals(cell.seed, t["rate_per_s"], cell.seconds)
        pick = generate.picks(cell.seed, len(due), t["frames"])
        trace = Trace() if cell.trace and cell.device.type == "cuda" else None
        if trace:
            service.batcher.call(Trace.warm).result()
        setup_s = ready(cell)
        before = service.stats()

        futures, t0, late, done = offer(
            service, frames, due, pick, cell.seconds - TRACE_S,
            (lambda: service.batcher.call(trace.start)) if trace else None)
        close = t0 + cell.seconds
        failed, results = 0, []
        for fut in futures:
            try:
                results.append(fut.result(timeout=max(close + GRACE_S - time.perf_counter(), 0)))
            except Exception:  # noqa: BLE001 — a failed or unanswered request
                results.append(None)
                failed += 1
        if trace:  # stopped once every answer is in
            service.batcher.call(trace.stop).result()
        memory = peak(cell)
        after = service.stats()
    finally:
        service.close()
    batches = after["batches"] - before["batches"]
    stats = {"batches": batches, "mean_batch_size": (
        after["mean_batch_size"] * after["batches"] - before["mean_batch_size"] * before["batches"]
    ) / batches if batches else 0.0}

    lat_ms = (done - (t0 + due)) * 1e3
    ok = np.isfinite(lat_ms)
    in_window = int((done[ok] <= close).sum())
    metrics = {"latency_p95_ms": float(np.percentile(lat_ms[ok], 95)) if ok.any() else None,
               "setup_s": setup_s}
    answered = [i for i, r in enumerate(results) if r is not None]
    chosen = set(np.asarray(answered)[generate.sample(cell.seed, len(answered),
                                                      t["check_requests"])].tolist())
    if answered:  # the slowest answer is always checked
        chosen.add(max(answered, key=lambda i: lat_ms[i]))
    chosen = sorted(chosen)
    return Outcome(attempted=len(due), failed=failed, metrics=metrics,
                   frames=frames[pick[chosen]], rows=[results[i] for i in chosen],
                   head=head(cell), cut=t["threshold"], memory_peak_bytes=memory,
                   trace=trace, stats=stats, latencies_ms=lat_ms,
                   notes={"offered_per_s": len(due) / cell.seconds,
                          "completed_in_window": in_window,
                          "generator_late_ms_p99": float(np.percentile(late, 99)) * 1e3,
                          "generator_late_ms_max": float(late.max()) * 1e3,
                          "latency_p50_ms": float(np.percentile(lat_ms[ok], 50)) if ok.any() else None,
                          "latency_max_ms": float(lat_ms[ok].max()) if ok.any() else None})
