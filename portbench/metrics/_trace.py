"""The device trace of a `--trace 1` run: torch.profiler over a steady
stretch of the window, reduced to device intervals, kernel time by part,
the busy and idle share, and the breakdown the result line carries.

Only the card's activities are recorded (CUPTI: kernels, copies, fills and
the CUDA runtime calls that issue them), not the host's operator calls:
recording those slows every launch, and where the host's launches pace the
card that slowdown reads as idle time of the card.

Kernel parts go by name, first match wins (the patterns of the port's own
profiling: cuDNN's and cuBLAS's kernel names for convolutions and matrix
products, the NMS kernel's `nms_*_kernel`).  Copies and fills are device
operations too: they count as busy time, in no kernel part.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

PARTS = (("k1", r"nms_\w+_kernel"),
         ("sort", r"[Ss]ort|[Rr]adix"),
         ("conv_matmul", r"conv|cudnn|xmma|gemm|cutlass|implicit|winograd|fft"),
         ("gather_index", r"[Gg]ather|[Ii]ndex|[Ss]catter"),
         ("copy", r"^Memcpy|^Memset|[Mm]emcpy|[Mm]emset"))
OTHER = "other"
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this many characters
TOP = 10
GAPS = 500        # the longest idle gaps that are named
LOOK_BACK = 500   # host operations searched back from a gap's middle


def part_of(name: str) -> str:
    return next((p for p, rx in PARTS if re.search(rx, name)), OTHER)


def _union(intervals):
    """Sorted, merged [start, end] of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Device operations of one profiled stretch, in seconds.

    ops: [(name, start_us, end_us)] of the card; host: the same of the CUDA
    runtime calls (every thread); window_s: the stretch's length by the host
    clock, from start() to stop() (the card synchronised at both ends);
    images and batches: what the stretch's entry completed in it."""

    def __init__(self):
        self.ops, self.host = [], []
        self.window_s = 0.0
        self.images = self.batches = 0
        self._prof = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that a later start inside
        the window does not pay its first set-up there."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def stop(self) -> None:
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        for e in self._prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            (self.ops if e.device_type == torch.autograd.DeviceType.CUDA else self.host).append(span)
        self._prof = None

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union((s, e) for _, s, e in self.ops)) / 1e6

    def idle_pct(self) -> float | None:
        if not self.ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def parts_s(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in self.ops:
            p = part_of(name)
            out[p] = out.get(p, 0.0) + (e - s) / 1e6
        return out

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 CUDA
        runtime calls under which the longest idle stretches of the card fell
        (each gap named by the shortest call spanning its middle; a gap under
        none is the host's own work between calls)."""
        by_op: dict[str, float] = {}
        for name, s, e in self.ops:
            by_op[name[:NAME_CHARS]] = by_op.get(name[:NAME_CHARS], 0.0) + (e - s) / 1e6
        busy = _union((s, e) for _, s, e in self.ops)
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
                       if b[0] > a[1]), reverse=True)[:GAPS]
        host = sorted((s, e, name) for name, s, e in self.host)
        starts = [h[0] for h in host]
        by_host: dict[str, float] = {}
        for length, s, e in gaps:
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            spans = [(he - hs, name) for hs, he, name in host[max(0, i - LOOK_BACK):i]
                     if he >= mid]
            name = min(spans)[1][:NAME_CHARS] if spans else "(host work between CUDA calls)"
            by_host[name] = by_host.get(name, 0.0) + length / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
