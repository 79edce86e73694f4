"""The policy of PyramidBoxDetector's CUDA-graph cache
(fdt_torch/infer/graphs.py), on the CPU: which calls go through it, when a
key runs eagerly, captures and replays, the keys, the LRU bound, what an
entry keeps alive, the recapture after new weight storage, the spans of a
replay, and threads sharing one detector.

The card is stubbed: `graphed` lets the cache take CPU detectors and puts
in a capture whose "graph" runs the captured chain again into the entry's
static output on replay, as a CUDA graph replays its kernels on the same
buffers.  The card's own capture and replay are held to the eager path bit
for bit in tests/test_torch_cuda.py.
"""
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdt_torch.dist import make_mesh
from fdt_torch.infer import PyramidBoxDetector, graphs
from fdt_torch.models import build_pyramidbox
from fdt_torch.utils import trace

torch.set_num_threads(1)


class _Graph:
    """Stands for a captured CUDA graph: replay() reruns the chain on the
    static input into the static output."""

    def __init__(self, chain, static_in):
        self.chain, self.static_in = chain, static_in
        self.out, self.keep = chain(static_in)

    def replay(self):
        self.out.copy_(self.chain(self.static_in)[0])


@pytest.fixture
def graphed(monkeypatch):
    """The cache takes CPU detectors; capture and replay stubbed; the
    counters start at 0.  Yields the graphs made."""
    made = []

    def capture(chain, static_in, pool):
        assert pool == "pool"
        made.append(_Graph(chain, static_in))
        return made[-1], made[-1].out, made[-1].keep

    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_pool", lambda: "pool")
    monkeypatch.setattr(graphs, "_replay", lambda graph, device: graph.replay())
    for c in (graphs.graph_captures, graphs.graph_replays, graphs.graph_eager):
        c.reset()
    yield made


def counts():
    return (graphs.graph_eager.count, graphs.graph_captures.count, graphs.graph_replays.count)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return build_pyramidbox("try3").eval()


def detector(model, **kw):
    return PyramidBoxDetector(model, "try3", device="cpu", **kw)


def frames(n=2, size=64, seed=0, width=None):
    return np.random.RandomState(seed).randint(0, 256, (n, size, width or size, 3),
                                               dtype=np.uint8)


def eager(det, images, conf=0.05, nms=0.3):
    dcfg = det._dcfg(torch.from_numpy(images), conf, nms)
    with torch.inference_mode():
        return det._detect_on(det.device, torch.from_numpy(images), dcfg).numpy()


def test_graphs_are_captured_on_cuda_alone_and_hold_32_shapes():
    assert graphs.DEVICE_TYPES == ("cuda",)
    assert graphs.MAX_ENTRIES >= 32


@pytest.mark.parametrize("case", ["cpu", "mesh", "int8", "detect_device"])
def test_ineligible_calls_stay_eager_and_move_no_counter(model, case, request):
    """The CPU (nothing stubbed), a mesh, int8 and detect_device called
    directly run the eager path: the counters stay at 0, no graph is made,
    and the answer is the eager one."""
    made = None if case == "cpu" else request.getfixturevalue("graphed")
    for c in (graphs.graph_captures, graphs.graph_replays, graphs.graph_eager):
        c.reset()
    kw = {"mesh": make_mesh(devices=[torch.device("cpu")] * 2)} if case == "mesh" else {}
    det = detector(model, **kw) if case != "int8" else detector(
        build_pyramidbox("try3").eval(), quant="int8")
    images = frames()
    for _ in range(3):
        if case == "detect_device":
            got = det.detect_device(torch.from_numpy(images), 0.05, 0.3).numpy()
        else:
            got = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.3)
    assert counts() == (0, 0, 0)
    assert made in (None, []) and not det._graphs.entries
    if case != "mesh":  # the mesh's shards pad the batch: its own test holds it
        assert np.array_equal(got, eager(det, images))


def test_first_call_eager_second_captures_later_ones_replay(model, graphed):
    det = detector(model)
    images = frames()
    want = eager(det, images)
    seen = []
    for _ in range(4):
        got = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.3)
        assert np.array_equal(got, want)
        seen.append(counts())
    assert seen == [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2)]
    assert len(graphed) == 1 and len(det._graphs.entries) == 1


def test_replay_reads_the_new_batch(model, graphed):
    """A replay copies each call's batch into the static input."""
    det = detector(model)
    a, b = frames(seed=1), frames(seed=2)
    for _ in range(2):
        det.detect_tensor(a, conf_thresh=0.05, nms_thresh=0.3)
    got = det.detect_tensor(b, conf_thresh=0.05, nms_thresh=0.3)
    assert counts() == (1, 1, 1)
    assert np.array_equal(got, eager(det, b))


@pytest.mark.parametrize("change", ["conf_thresh", "nms_thresh", "batch", "height", "width"])
def test_a_new_threshold_or_shape_is_a_new_key(model, graphed, change):
    det = detector(model)
    kw = {"conf_thresh": 0.05, "nms_thresh": 0.3}
    for _ in range(2):
        det.detect_tensor(frames(), **kw)
    images = {"batch": frames(n=3), "height": frames(size=48, width=64),
              "width": frames(size=64, width=48)}.get(change, frames())
    if change in kw:
        kw[change] = 0.2
    got = [det.detect_tensor(images, **kw) for _ in range(3)]
    assert counts() == (2, 2, 1)
    want = eager(det, images, kw["conf_thresh"], kw["nms_thresh"])
    assert all(np.array_equal(g, want) for g in got)


def test_lru_holds_max_entries_and_drops_the_least_recent(model, graphed):
    """MAX_ENTRIES keys captured (here by threshold), one more evicts the
    least recently used: its graph is dropped and its key starts over."""
    det = detector(model)
    images = frames(n=1)
    threshes = [0.01 * (i + 1) for i in range(graphs.MAX_ENTRIES + 1)]
    for t in threshes[:-1]:
        for _ in range(2):
            det.detect_tensor(images, conf_thresh=t)
    assert len(det._graphs.entries) == graphs.MAX_ENTRIES
    det.detect_tensor(images, conf_thresh=threshes[0])  # now the most recent
    first = weakref.ref(graphed[1])
    graphed.clear()
    for _ in range(2):
        det.detect_tensor(images, conf_thresh=threshes[-1])
    assert len(det._graphs.entries) == graphs.MAX_ENTRIES
    gc.collect()
    assert first() is None  # the second key's graph: the least recent one
    keys = [k[1].conf_thresh for k in det._graphs.entries]
    assert keys[0] == threshes[2] and keys[-1] == threshes[-1] and threshes[1] not in keys
    before = counts()
    det.detect_tensor(images, conf_thresh=threshes[1])  # evicted: eager again
    assert counts() == (before[0] + 1, before[1], before[2])


def test_keys_seen_once_are_bounded_and_capture_nothing(model, graphed):
    det = detector(model)
    images = frames(n=1, size=32)
    for i in range(graphs.MAX_SEEN + 2):
        det.detect_tensor(images, conf_thresh=0.001 * (i + 1))
    assert counts() == (graphs.MAX_SEEN + 2, 0, 0)
    assert len(det._graphs.seen) == graphs.MAX_SEEN and not det._graphs.entries


def test_an_entry_keeps_its_priors_after_the_priors_lru_drops_them(model, graphed):
    det = detector(model)
    det._priors_max = 1
    for _ in range(2):
        det.detect_tensor(frames(), conf_thresh=0.05)
    (entry,) = det._graphs.entries.values()
    priors = weakref.ref(entry.keep[0])
    assert entry.keep[0] is det._priors[(64, 64)][1][torch.device("cpu")]
    det.detect_tensor(frames(size=48), conf_thresh=0.05)  # evicts 64²'s priors
    assert (64, 64) not in det._priors
    gc.collect()
    assert priors() is not None
    det._graphs.entries.clear()
    del entry
    graphed.clear()
    gc.collect()
    assert priors() is None


def test_a_replay_is_a_use_of_its_size_in_the_priors_lru(model, graphed):
    """Replays keep their size the LRU's most recent and cut the LRU to a
    bound lowered on the instance; an evicted size's graph still replays
    its answer."""
    det = detector(model)
    sizes = [64, 48, 32]
    for size in sizes:
        for _ in range(2):
            det.detect_tensor(frames(size=size), conf_thresh=0.05)
    det.detect_tensor(frames(size=64), conf_thresh=0.05)  # a replay
    assert list(det._priors) == [(48, 48), (32, 32), (64, 64)]
    det._priors_max = 1
    det.detect_tensor(frames(size=48), conf_thresh=0.05)  # a replay
    assert list(det._priors) == [(48, 48)] and counts() == (3, 3, 2)
    got = det.detect_tensor(frames(size=64), conf_thresh=0.05)  # evicted, replayed
    assert counts() == (3, 3, 3)
    assert np.array_equal(got, eager(det, frames(size=64), nms=det.detect_cfg.nms_thresh))


def test_new_weight_storage_recaptures(model, graphed):
    """The model's weights moved to new storage (as a cast or a move in
    place does) since the capture: the next call captures again."""
    det = detector(build_pyramidbox("try3").eval())
    images = frames()
    for _ in range(3):
        det.detect_tensor(images, conf_thresh=0.05)
    assert counts() == (1, 1, 1)
    with torch.no_grad():
        for p in det.model.parameters():
            p.data = p.data.clone()
    got = det.detect_tensor(images, conf_thresh=0.05)
    assert counts() == (1, 2, 1)
    assert np.array_equal(got, eager(det, images, nms=det.detect_cfg.nms_thresh))
    det.detect_tensor(images, conf_thresh=0.05)
    assert counts() == (1, 2, 2)
    for buf in det.model.buffers():  # a buffer of new storage counts too
        buf.data = buf.data.clone()
    det.detect_tensor(images, conf_thresh=0.05)
    assert counts() == (1, 3, 2)


def test_weights_probe_reads_pointers_of_its_own_model_only(model):
    probe = graphs._Weights(model)
    assert len(probe.slots) == 4
    assert probe.read(model) == probe.read(model) is not None
    assert probe.read(build_pyramidbox("try3")) is None


def test_a_replay_records_upload_forward_and_readback(model, graphed):
    """On a replay `detect.head` is not opened: its work is in the graph."""
    det = detector(model)
    images = frames()
    for _ in range(2):
        det.detect_tensor(images, conf_thresh=0.05)
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        det.detect_tensor(images, conf_thresh=0.05)
    spans = trace.drain().spans
    assert [(s.name, s.parent) for s in spans] == [
        ("detect", -1), ("detect.upload", 0), ("model.forward", 0), ("detect.readback", 0)]


def test_threads_sharing_a_detector_get_their_own_answers(model, graphed):
    """Eight threads, two keys, one detector, a short switch interval: every
    answer is its batch's eager one, and each key is captured once."""
    det = detector(model)
    batches = [frames(n=1, size=32, seed=s) for s in range(4)]
    wants = {(s, t): eager(det, batches[s], t, 0.3) for s in range(4) for t in (0.05, 0.1)}
    errors = []

    def work(i):
        try:
            for k in range(6):
                s, t = (i + k) % 4, (0.05, 0.1)[(i + k) % 2]
                got = det.detect_tensor(batches[s], conf_thresh=t, nms_thresh=0.3)
                if not np.array_equal(got, wants[(s, t)]):
                    errors.append((i, k))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    eager_n, captures, replays = counts()
    assert (eager_n, captures) == (2, 2) and eager_n + captures + replays == 48
