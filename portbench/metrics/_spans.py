"""The program's own spans on a traced stretch's device timeline, and the
arithmetic the span readers share.

The program (fdt_torch.utils.trace) records spans at its detect path's
boundaries while a torch.profiler session runs, so a traced stretch holds
them and an untraced run records none.  The first reader of a run drains
them (once: the result is kept on the run record) and keeps those of the
stretch.  A checkout whose program has no such recorder gives no spans, and
every reader then returns None.

Two clocks meet here.  The spans are on the host clock (perf_counter), as
is the stretch (Trace._t0, window_s); the card's activities and the CUDA
runtime calls are in microseconds from the profiler's own start, which the
Trace does not keep.  One event joins them: Trace.stop() synchronises the
card (torch.cuda.synchronize, a cudaDeviceSynchronize: the first after the
stretch's last launch or copy) and reads the host clock as it returns, so
that call's end is the stretch's end on both clocks.  The spans are placed
by it.  The card test `test_profiled_detect_spans_hold_the_threads_launch_calls`
holds this placement to the exact one (the profiler's start on
CLOCK_REALTIME) within 20 µs, and finds no launch call in `detect.readback`.

Every idle microsecond of the stretch (no kernel, copy or fill on the card,
as idle_pct.batch counts) goes to the innermost span open at that instant
on the detecting thread (the thread with the most `detect` spans): upload
under `detect.upload`, readback under `detect.readback`, launch under any
other span of the detect path (`model.forward`, `detect.head`, `detect`
itself), caller under none.  A gap that several spans cover is split among
them.  A part holds every idle instant of its span, the card's own gaps
between operations it already had queued as well as its waits for the
host: while the host waits in `detect.readback` for a card that is behind,
the gaps between the kernels still queued fall there (most of try1.batch's
readback share).  Telling the two apart takes each operation's runtime
call, which the trace keeps only by name and time: matched by order, they
come apart on the card (the profiler loses activity records), so the split
waits for the trace to keep the profiler's correlation ids.  The runtime calls are not told
apart by thread: in the batch cells one thread issues every CUDA call.
"""
from __future__ import annotations

import bisect
import re

from portbench.metrics._trace import _union

PARTS = {"detect.upload": "upload", "detect.readback": "readback"}  # any other span: launch
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
IO = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy|cuMemcpy|cudaMemset|cuMemset)")
STOP_SYNC = "cudaDeviceSynchronize"


def _drain():
    """The program's recording, or None where the program has no recorder."""
    try:
        from fdt_torch.utils import trace
    except ImportError:
        return None
    return trace.drain()


class Placed:
    """A run's spans on the trace's clock (µs), with its window."""

    def __init__(self, trace, spans, images, window):
        self.trace = trace
        self.spans = spans      # [(start_us, end_us, name)] of the detecting thread
        self.images = images    # the images of its `detect` spans
        self.window = window    # (start_us, end_us) of the stretch

    def total_ms(self, name: str) -> float:
        return sum(e - s for s, e, n in self.spans if n == name) / 1e3


def window_end_us(trace) -> float | None:
    """The end of Trace.stop()'s synchronise on the trace's clock."""
    io_end = max((e for name, _, e in trace.host if IO.match(name)), default=None)
    if io_end is None:
        return None
    ends = [(s, e) for name, s, e in trace.host if name == STOP_SYNC and s >= io_end]
    return min(ends)[1] if ends else None


def placed(run) -> Placed | None:
    """The run's spans placed on its trace, or None (no trace, no spans, or
    no anchor); drained once, kept on the run record."""
    cache = vars(run)
    if "_placed" not in cache:
        cache["_placed"] = _place(run.trace, _drain()) if run.trace is not None else None
    return cache["_placed"]


def _place(trace, recording) -> Placed | None:
    if recording is None or trace.window_s <= 0:
        return None
    end_us = window_end_us(trace)
    if end_us is None:
        return None
    end_ns = round((trace._t0 + trace.window_s) * 1e9)  # the stretch's end, perf_counter
    w0 = end_us - trace.window_s * 1e6

    def us(ns):
        return (ns - end_ns) / 1e3 + end_us
    # the stretch's spans: a profiler session before it may have left others
    mine = [sp for sp in recording.spans
            if sp.end_ns is not None and us(sp.end_ns) > w0 and us(sp.start_ns) < end_us]
    roots: dict[int, int] = {}
    for sp in mine:
        if sp.name == "detect" and sp.parent == -1:
            roots[sp.thread] = roots.get(sp.thread, 0) + 1
    if not roots:
        return None
    thread = max(roots, key=roots.get)
    mine = [sp for sp in mine if sp.thread == thread]
    return Placed(trace, [(us(sp.start_ns), us(sp.end_ns), sp.name) for sp in mine],
                  sum(sp.count for sp in mine if sp.name == "detect" and sp.parent == -1),
                  (w0, end_us))


def innermost(spans) -> list[tuple[float, float, str]]:
    """Disjoint (start, end, name) pieces: at each instant the innermost of
    properly nested spans (start, end, name)."""
    pieces, stack, t = [], [], 0.0

    def close(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close(float("inf"))
    return pieces


def idle_split_s(run) -> dict[str, float] | None:
    """Seconds of the stretch's idle time under each part: upload, launch,
    readback, caller."""
    p = placed(run)
    if p is None:
        return None
    w0, w1 = p.window
    busy = [(max(s, w0), min(e, w1)) for s, e in _union((s, e) for _, s, e in p.trace.ops)
            if e > w0 and s < w1]
    idle, t = [], w0
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    out = dict.fromkeys(("upload", "launch", "readback", "caller"), 0.0)
    pieces = innermost(p.spans)
    j = 0
    for s, e in idle:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[PARTS.get(name, "launch")] += part
                covered += part
            k += 1
        out["caller"] += (e - s) - covered
    return {k: v / 1e6 for k, v in out.items()}


def idle_pct(run, part: str) -> float | None:
    split = idle_split_s(run)
    return None if split is None else 100.0 * split[part] / run.trace.window_s


def ms_per_image(run, name: str) -> float | None:
    """Host milliseconds an image inside spans called `name`."""
    p = placed(run)
    if p is None or not p.images:
        return None
    return p.total_ms(name) / p.images


def launches_in(p: Placed, names) -> tuple[int, int]:
    """(launch calls whose start lies inside a span called one of `names`,
    launch calls of the stretch)."""
    starts = sorted(s for name, s, _ in p.trace.host if LAUNCH.match(name))
    inside = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in _union((s, e) for s, e, n in p.spans if n in names))
    return inside, len(starts)


def launches_per_image(run, name: str) -> float | None:
    p = placed(run)
    if p is None or not p.images:
        return None
    return launches_in(p, {name})[0] / p.images
