"""The port's own tracing: launch counters, and spans at the detect path's
boundaries.

  Counter  a count a kernel wrapper bumps once a launch (`.count`,
           `.reset()`); the card tests and chip_smoke.py read them.
  span     `with span(name, count):` records one span: its name, start and
           end (`time.perf_counter_ns()`), the thread (its native id), the
           index of the span open around it on that thread (-1 at a root),
           a call id that every span under one root shares, and a count
           (a detect root carries its batch size).
  span_once  the same, unless a span of that name is already open on the
           thread: a public entry that another calls records one span.

Recording is on while a torch.profiler session runs in the process (torch's
own `torch.autograd.profiler._is_profiler_enabled` flag, the one torch's
compilers test), so that a profiled stretch holds the program's spans beside
the card's activities with no change to the code that profiles, and any
other run records nothing.  Off, span() tests that flag and returns one
shared no-op object: no clock read, no allocation.  On, spans go to one
bounded list of CAPACITY entries; past it they are dropped and counted in
`dropped`.  Nothing drains the list but drain(): a profiler session that
does not drain it leaves at most CAPACITY spans (about 16 MB) behind, and
a later drain returns them too, so a reader keeps those of its own stretch.

drain() empties the list and returns a Recording: the spans on
`time.perf_counter_ns()`'s clock, and one (perf_counter_ns, time_ns) pair
read at the first span after the previous drain, which puts them on
CLOCK_REALTIME (the clock torch.profiler stamps host events on).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

if not hasattr(_profiler, "_is_profiler_enabled"):
    raise ImportError("torch.autograd.profiler._is_profiler_enabled is gone from this torch: "
                      "fdt_torch.utils.trace records while a profiler runs by that flag")

CAPACITY = 1 << 16  # spans held until a drain


class Counter:
    """A count: a kernel wrapper adds one per launch."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


dropped = Counter()  # spans past CAPACITY since the process started


class Span(NamedTuple):
    name: str
    start_ns: int        # time.perf_counter_ns()
    end_ns: int | None   # the same; None: still open at the drain
    thread: int          # threading.get_native_id() of the recording thread
    parent: int          # index in the same Recording of the span around it, -1 at a root
    call: int            # shared by a root and every span under it
    count: int


class Recording(NamedTuple):
    spans: list
    perf_ns: int  # the clock pair: perf_counter_ns ...
    real_ns: int  # ... and time_ns at the same instant

    def to_real_ns(self, perf_ns: int) -> int:
        """A stamp of the spans' clock on CLOCK_REALTIME."""
        return perf_ns - self.perf_ns + self.real_ns


class _Off:
    """The shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_records: list = []  # [name, start, end, thread, parent, call, count, index, generation]
_generation = 0      # bumped by each drain
_pair: tuple | None = None
_lock = threading.Lock()
_calls = itertools.count()
_local = threading.local()  # .open: this thread's open records; .tid: its native id


def _clock_pair() -> tuple[int, int]:
    p0 = time.perf_counter_ns()
    real = time.time_ns()
    return (p0 + time.perf_counter_ns()) // 2, real


class _Span:
    __slots__ = ("name", "count", "rec")

    def __init__(self, name: str, count: int):
        self.name, self.count, self.rec = name, count, None

    def __enter__(self):
        global _pair
        local = _local.__dict__
        stack = local.get("open")
        if stack is None:
            stack = local["open"] = []
            local["tid"] = threading.get_native_id()
        with _lock:
            if len(_records) >= CAPACITY:
                dropped.count += 1
                return self
            if _pair is None:
                _pair = _clock_pair()
            up = stack[-1] if stack else None
            parent = up[7] if up is not None and up[8] == _generation else -1
            call = up[5] if up is not None else next(_calls)
            rec = [self.name, 0, None, local["tid"], parent, call, self.count, len(_records),
                   _generation]
            _records.append(rec)
        stack.append(rec)
        self.rec = rec
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
            _local.open.pop()
        return False


def span(name: str, count: int = 0):
    """A context manager recording one span while recording is on."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, count)


def span_once(name: str, count: int = 0):
    """span(name, count), unless a span called `name` is open on this thread."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if any(rec[0] == name for rec in getattr(_local, "open", ())):
        return _OFF
    return _Span(name, count)


def drain() -> Recording:
    """Every span recorded since the last drain, and the list emptied.  A
    span still open keeps end_ns None (its end is not recorded); drain
    between calls of the traced code."""
    global _records, _pair, _generation
    with _lock:
        records, pair = _records, _pair or _clock_pair()
        _records, _pair = [], None
        _generation += 1
    return Recording([Span(*r[:7]) for r in records], *pair)
