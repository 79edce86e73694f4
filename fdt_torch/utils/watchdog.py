"""Stall watchdog: turn a wedged training step into a bounded restart (a
copy of fdt/utils/watchdog.py, which imports no JAX; the port imports
nothing of fdt).

The reference's only failure-recovery story is crash-resume via the
``--resume <ckpt> --start_iter N`` restart contract.  A HANG has no such
story: a device execution that never completes blocks the host in a C call
that Python cannot interrupt.

So a daemon thread watches a heartbeat and hard-exits (``os._exit``) with a
distinctive code once the gap exceeds the limit; a chained-restart runner
recognises that code and re-runs from the last checkpoint, converting an
unbounded wedge into ``limit`` seconds of lost wall clock.
"""
from __future__ import annotations

import os
import sys
import threading
import time

# distinctive exit code: "stalled, safe to retry from the last checkpoint"
STALL_EXIT_CODE = 86


class StallWatchdog:
    """Hard-exits the process when ``beat()`` stops arriving.

    Monitoring starts at the FIRST beat, not at construction: the gap to the
    first beat includes unbounded one-off work (kernel builds, the first
    step's cuDNN planning) that must not trip the limit.  Every later gap > ``limit_s`` triggers ``on_stall`` (default:
    diagnostic line on stderr, then ``os._exit(STALL_EXIT_CODE)``).

    The first-beat exemption leaves one wedge uncovered: a hang BEFORE any
    beat (in device initialisation, say).  ``startup_limit_s``
    bounds that window separately: no first beat within it since
    construction → fire.  It must budget for everything one-off (imports,
    checkpoint restore, kernel builds), so it is typically several
    times ``limit_s``; 0/None disables it (the default).

    ``limit_s <= 0`` disables the watchdog entirely (no thread started), so
    callers can wire it unconditionally and gate via config.
    """

    def __init__(self, limit_s: float, on_stall=None, name: str = "",
                 poll_s: float | None = None,
                 startup_limit_s: float | None = None):
        self.limit_s = float(limit_s)
        self.startup_limit_s = float(startup_limit_s or 0)
        self.name = name
        self._on_stall = on_stall or self._default_on_stall
        self._last: float | None = None     # None until the first beat
        self._born = time.monotonic()
        self._closed = threading.Event()
        self._thread = None
        if self.limit_s > 0:
            self._poll = poll_s if poll_s is not None else min(
                5.0, self.limit_s / 4)
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name=f"stall-watchdog:{name}")
            self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def close(self) -> None:
        """Stop monitoring (run finished or is shutting down cleanly)."""
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ---------------------------------------------------------
    def _watch(self):
        while not self._closed.wait(self._poll):
            last = self._last
            if last is None:
                if (self.startup_limit_s > 0 and
                        time.monotonic() - self._born > self.startup_limit_s):
                    self._on_stall(time.monotonic() - self._born)
                    return
                continue                     # pre-first-beat grace
            gap = time.monotonic() - last
            if gap > self.limit_s:
                self._on_stall(gap)
                return

    def _default_on_stall(self, gap: float):
        print(f"[watchdog:{self.name}] no heartbeat for {gap:.0f}s "
              f"(limit {self.limit_s:.0f}s) — assuming a wedged device "
              f"execution; exiting {STALL_EXIT_CODE} for the chained runner "
              f"to retry from the last checkpoint", file=sys.stderr,
              flush=True)
        sys.stderr.flush()
        os._exit(STALL_EXIT_CODE)
