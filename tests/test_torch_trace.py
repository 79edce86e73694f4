"""fdt_torch.utils.trace: the launch counters' home, the span recorder, the
spans of PyramidBoxDetector's detect path, and MicroBatcher's counters."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdt_torch.apps.serving import MicroBatcher
from fdt_torch.infer import PyramidBoxDetector
from fdt_torch.models import build_pyramidbox
from fdt_torch.ops import nms, quant, track
from fdt_torch.utils import trace

torch.set_num_threads(1)

DETECT = ["detect", "detect.upload", "model.forward", "detect.head", "detect.readback"]


@pytest.fixture
def recorder():
    """Recording is on while a profiler session runs."""
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        yield trace
    trace.drain()


@pytest.fixture(scope="module")
def detector():
    torch.manual_seed(0)
    return PyramidBoxDetector(build_pyramidbox("try3"), "try3", device="cpu")


def frames(n=2, size=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_kernel_counters_live_in_trace():
    for counter in (nms.launches, nms.greedy_launches, quant.launches,
                    quant.mma_sync_launches, quant.quantize_launches, track.launches,
                    track.global_launches):
        assert isinstance(counter, trace.Counter)
    c = trace.Counter()
    c.count += 3
    assert c.count == 3
    c.reset()
    assert c.count == 0


def test_the_switch_is_torchs_profiler_flag():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert trace.span("detect") is not trace._OFF
    assert trace.span("detect") is trace._OFF


def test_off_records_nothing_and_shares_one_no_op():
    trace.drain()
    a, b = trace.span("detect", 4), trace.span_once("detect")
    assert a is b is trace._OFF
    with a:
        with trace.span("inner"):
            pass
    assert trace.drain().spans == []


def test_nesting_parent_and_call_ids(recorder):
    with trace.span("detect", 8):
        with trace.span_once("detect"):  # already open: no second span
            with trace.span("model.forward"):
                with trace.span("detect.head"):
                    pass
        with trace.span("detect.readback"):
            pass
    with trace.span("detect", 2):
        pass
    spans = trace.drain().spans
    assert [(s.name, s.parent, s.count) for s in spans] == [
        ("detect", -1, 8), ("model.forward", 0, 0), ("detect.head", 1, 0),
        ("detect.readback", 0, 0), ("detect", -1, 2)]
    assert len({s.call for s in spans[:4]}) == 1 and spans[4].call != spans[0].call
    for s in spans:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_each_thread_keeps_its_own_nesting(recorder):
    inside = threading.Event()

    def other():
        with trace.span("detect", 1):
            inside.set()
            time.sleep(0.01)
    with trace.span("detect", 3):
        t = threading.Thread(target=other)
        t.start()
        inside.wait(10)
        with trace.span("detect.upload"):
            pass
        t.join(10)
    assert not t.is_alive()
    spans = trace.drain().spans
    mine = threading.get_native_id()
    by_name = {(s.name, s.thread == mine): s for s in spans}
    assert by_name[("detect", False)].parent == -1
    upload = by_name[("detect.upload", True)]
    assert spans[upload.parent] == by_name[("detect", True)]
    assert by_name[("detect", False)].call != by_name[("detect", True)].call


def test_the_bound_drops_and_counts(recorder, monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    before = trace.dropped.count
    for _ in range(5):
        with trace.span("detect"):
            with trace.span("model.forward"):
                pass
    assert len(trace._records) == 3
    assert trace.dropped.count - before == 7
    assert [s.name for s in trace.drain().spans] == ["detect", "model.forward", "detect"]


def test_clock_conversion_is_monotone_and_on_time_ns(recorder):
    for _ in range(50):
        with trace.span("detect"):
            pass
    after = time.time_ns()
    rec = trace.drain()
    real = [(rec.to_real_ns(s.start_ns), rec.to_real_ns(s.end_ns)) for s in rec.spans]
    assert [a for a, _ in real] == sorted(a for a, _ in real)
    assert all(b >= a for a, b in real)
    assert abs(after - real[-1][1]) < 50_000
    assert rec.to_real_ns(rec.perf_ns) == rec.real_ns
    # a stamp taken now lands within 50 µs of time.time_ns() read beside it
    with trace.span("now"):
        now = time.time_ns()
    rec = trace.drain()
    assert abs(rec.to_real_ns(rec.spans[0].start_ns) - now) < 50_000


def test_recording_follows_torch_profiler():
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("detect", 1):
            pass
    with trace.span("detect", 1):
        pass
    assert [s.name for s in trace.drain().spans] == ["detect"]


def test_detect_tensor_records_its_five_spans_once_a_call(detector, recorder):
    images = frames()
    for _ in range(2):
        detector.detect_tensor(images, conf_thresh=0.0)
    spans = trace.drain().spans
    assert [s.name for s in spans] == DETECT * 2
    for call in (spans[:5], spans[5:]):
        root = call[0]
        assert root.parent == -1 and root.count == 2
        assert {s.call for s in call} == {root.call}
        children = call[1:]
        assert all(spans[s.parent] == root for s in children)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in children)
        assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))


def test_detect_device_alone_opens_the_root(detector, recorder):
    detector.detect_device(torch.from_numpy(frames(3)))
    assert [(s.name, s.parent, s.count) for s in trace.drain().spans] == [
        ("detect", -1, 3), ("detect.upload", 0, 0), ("model.forward", 0, 0),
        ("detect.head", 0, 0)]


def test_detect_output_bit_equal_with_the_recorder_on_and_off(detector):
    images = frames(seed=1)
    off = detector.detect_tensor(images, conf_thresh=0.0)
    with profile(activities=[ProfilerActivity.CPU]):
        on = detector.detect_tensor(images, conf_thresh=0.0)
    assert len(trace.drain().spans) == len(DETECT)
    assert np.array_equal(off, on)


def test_microbatcher_counts_queue_waits_and_busy_time():
    def slow(items):
        time.sleep(0.05)
        return items
    mb = MicroBatcher(slow, max_batch=1, max_wait_ms=0)
    try:
        futures = [mb.submit(i) for i in range(3)]
        assert [f.result(timeout=30) for f in futures] == [0, 1, 2]
        st = mb.stats()
        # one request at a time behind 50 ms batches: waits ~0, ~50 and ~100 ms
        assert st["queue_wait_ms_max"] >= 95
        assert 45 <= st["queue_wait_ms_mean"] < st["queue_wait_ms_max"]
        assert 0.3 < st["worker_busy_share"] <= 1.0
        time.sleep(0.2)
        assert mb.stats()["worker_busy_share"] < st["worker_busy_share"]
    finally:
        mb.close()
    closed = mb.stats()["worker_busy_share"]
    time.sleep(0.05)
    assert mb.stats()["worker_busy_share"] == closed  # the lifetime ends with the worker


def test_microbatcher_counters_start_at_zero():
    with MicroBatcher(lambda items: items) as mb:
        st = mb.stats()
    assert st["queue_wait_ms_mean"] == st["queue_wait_ms_max"] == 0.0
    assert st["worker_busy_share"] == 0.0
