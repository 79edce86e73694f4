"""What a cell's window drives: one module a traffic mix's `kind`, in a file
named as the kind (`<kind>.py`), found by that name.  Its
`run(cell, detector=None)` sets up, drives the window and returns an
Outcome; `detector` is a program object built elsewhere (the tools reuse
one across windows).  A module may also define `check(cell, outcome)`,
returning ({number: value}, the reference's results), for answers that are
not rows of boxes and scores; without one the harness compares rows
(portbench.check).

  batch  the configuration's detector in a closed loop of batches from host
         memory (batch.py)
  serve  the configuration's detector behind fdt_torch's DetectionService
         under open-loop arrivals (serve.py)

A traced run profiles a steady stretch of TRACE_S seconds of its window
(portbench.metrics._trace) and keeps everything else the same.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import re
import time

import numpy as np
import torch

from portbench.metrics._trace import Trace
from portbench.reference.detect import HeadSettings

GRACE_S = 60.0    # how long past the window's close an answer is waited for
WARMUP_S = 1.0    # a batch cell's warm-up: its own batches, unmeasured
TRACE_S = 2.0     # the profiled stretch of a traced run
TRACE_START = 0.5  # a batch cell's stretch starts at this share of its window
KIND = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict                       # end-to-end name → value
    frames: np.ndarray                  # [n, H, W, 3] uint8: the checked images
    rows: list                          # the program's [m, 5] pixel rows of each
    head: HeadSettings
    cut: float                          # the rows' score threshold
    memory_peak_bytes: int = 0
    trace: Trace | None = None
    traced: list = dataclasses.field(default_factory=list)  # indices into frames
    stats: dict = dataclasses.field(default_factory=dict)
    untraced_images_per_s: float | None = None
    notes: dict = dataclasses.field(default_factory=dict)
    latencies_ms: np.ndarray | None = None  # a serving window's, in arrival order


def load(kind: str):
    """The entry module of a traffic kind, or None when there is none."""
    if not KIND.match(kind) or importlib.util.find_spec(f"{__name__}.{kind}") is None:
        return None
    return importlib.import_module(f"{__name__}.{kind}")


def head(cell) -> HeadSettings:
    t = cell.traffic
    return HeadSettings(t["threshold"], t["nms_thresh"], cell.config["budget"],
                        cell.config["top_k"])


def tracer(cell) -> Trace | None:
    """A warmed profiler for a traced run on the card, else None."""
    if not (cell.trace and cell.device.type == "cuda"):
        return None
    Trace.warm()
    return Trace()


def ready(cell) -> float:
    """End of set-up: the card idle, and every object made so far moved out
    of the cyclic collector's reach (gc.freeze), so that a full collection
    inside the window scans only what the window makes, not the interpreter's
    and torch's heap; returns setup_s."""
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    return time.perf_counter() - cell.t_start


def peak(cell) -> int:
    return torch.cuda.max_memory_allocated() if cell.device.type == "cuda" else 0
