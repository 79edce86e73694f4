"""CUDA graphs of a detector's device chain, one a batch shape.

A detector's eager chain enqueues hundreds of kernels a batch, one launch
call each; on a host slower than the card those calls, not the card, set
the pace.  A captured graph replays the whole chain in one call.

GraphCache is a detector's cache of captured chains, keyed by what a chain
bakes in (the detector passes its device, batch shape and detect settings).
A key's first call runs eagerly (it warms cuDNN, the detector's caches and
lazy initialisation; a size seen once never pays for a capture), its second
captures, every later one replays: the batch is copied into the entry's
static input on the card, the graph replayed, its static output read back.
Every graph of a cache draws on one memory pool, so the cache holds about
the largest graph's working memory and not the sum; a lock per cache keeps
replays and their readbacks in turn, as the shared pool and static buffers
need.  An entry keeps every tensor its graph reads (what the chain returns
beside its output: priors, say, that the detector's own LRU may drop), and
the places of the model's first and last parameter and buffer: a replay
whose model was moved or cast since (new storage) captures again.  At most
MAX_ENTRIES graphs are kept, least recently used dropped first.

Counters: `graph_captures`, `graph_replays`, and `graph_eager` (calls that
ran eagerly because their key was new); replays over the three together is
the cache's hit share.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from fdt_torch.utils import trace

DEVICE_TYPES = ("cuda",)  # where a chain is captured
MAX_ENTRIES = 32  # the serve CLI's max_batch: batch sizes 1-32 never thrash
MAX_SEEN = 64     # keys seen once, waiting for a second call

graph_captures = trace.Counter()
graph_replays = trace.Counter()
graph_eager = trace.Counter()


class _Weights:
    """Where the model's first and last parameter and buffer live, found
    once; `read()` gives their data pointers again in a few microseconds
    (walking every parameter takes hundreds)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        slots = []
        for kind in ("_parameters", "_buffers"):
            named = [(m, kind, n) for m in model.modules()
                     for n, t in getattr(m, kind).items() if t is not None]
            slots += named[:1] + named[-1:]
        self.slots = slots

    def read(self, model: torch.nn.Module) -> tuple | None:
        if model is not self.model:
            return None
        try:
            return tuple(getattr(m, kind)[n].data_ptr() for m, kind, n in self.slots)
        except (KeyError, AttributeError):  # a slot went: the model changed shape
            return None


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "keep", "weights", "fingerprint")

    def __init__(self, graph, static_in, static_out, keep, weights):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.keep = keep
        self.weights = weights
        self.fingerprint = weights.read(weights.model)


def _capture(chain: Callable, static_in: torch.Tensor, pool) -> tuple:
    """PyTorch's recipe: the chain once on a side stream, then captured into
    a graph on `pool`.  Returns (graph, its static output, what it keeps)."""
    device = static_in.device
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chain(static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's eager work on the card stays legal
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out, keep = chain(static_in)
    return graph, out, keep


def _pool():
    return torch.cuda.graph_pool_handle()


def _replay(graph, device: torch.device) -> None:
    with torch.cuda.device(device):
        graph.replay()


class GraphCache:
    """A detector's captured chains (the module's docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.entries: OrderedDict = OrderedDict()  # key → _Entry, least recent first
        self.seen: OrderedDict = OrderedDict()     # keys called once
        self.pool = None

    def detect(self, key, images: torch.Tensor, model: torch.nn.Module,
               chain: Callable, eager: Callable) -> np.ndarray:
        """`images` (any device) through the graph of `key` on the cache's
        device, read back.

        chain(static_in) → (device output, tensors the graph reads): the
        chain to capture.  eager(images) → device output: a first call's.
        `model` is the module the chain runs, checked before a replay."""
        with self.lock:
            entry = self.entries.get(key)
            if entry is None and key not in self.seen:
                self.seen[key] = None
                while len(self.seen) > MAX_SEEN:
                    self.seen.popitem(last=False)
                graph_eager.count += 1
                out = eager(images)
                with trace.span("detect.readback"):
                    return out.cpu().numpy()
            if entry is None or entry.weights.read(model) != entry.fingerprint:
                entry = self._capture(key, images, model, chain)  # new, or stale weights
            else:
                self.entries.move_to_end(key)
                with trace.span("detect.upload"):
                    entry.static_in.copy_(images, non_blocking=True)
                graph_replays.count += 1
            with trace.span("model.forward"):
                _replay(entry.graph, self.device)
            with trace.span("detect.readback"):
                return entry.static_out.cpu().numpy()

    def _capture(self, key, images, model, chain) -> _Entry:
        self.entries.pop(key, None)  # a stale graph goes before its successor is made
        self.seen.pop(key, None)
        with trace.span("detect.upload"):
            static_in = torch.empty(images.shape, dtype=images.dtype, device=self.device)
            static_in.copy_(images, non_blocking=True)
        if self.pool is None:
            self.pool = _pool()
        with trace.span("model.forward"):
            graph, out, keep = _capture(chain, static_in, self.pool)
        entry = self.entries[key] = _Entry(graph, static_in, out, keep, _Weights(model))
        while len(self.entries) > MAX_ENTRIES:
            self.entries.popitem(last=False)
        graph_captures.count += 1
        return entry
