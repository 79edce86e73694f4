"""The span readers on a hand-made trace: the idle partition, the launch
count inside model.forward, the host ms an image, and None without spans.

The stretch is 1000 µs: [500, 1500] on the trace's clock, whose end is the
end of Trace.stop()'s cudaDeviceSynchronize; one detect call of 2 images
on thread 7 spans [600, 1400]."""
import sys
import types

import pytest

import fdt_torch.utils
from fdt_torch.utils.trace import Recording, Span
from portbench import harness
from portbench.metrics import _spans
from portbench.metrics._trace import Trace
from portbench.tests.conftest import REPO

T0_S = 100.0            # Trace._t0, perf_counter seconds
WINDOW_S = 0.001
END_US = 1500.0         # the stop's synchronise ends here on the trace's clock
REAL_OFF = 10**12       # the recording's CLOCK_REALTIME minus perf_counter_ns


def perf(us: float) -> int:
    """The perf_counter ns of an instant at `us` on the trace's clock."""
    return round((T0_S + WINDOW_S) * 1e9) + round((us - END_US) * 1e3)


def span(name, s, e, parent, thread=7, count=0, call=0):
    return Span(name, perf(s), perf(e), thread, parent, call, count)


SPANS = [span("detect", 600, 1400, -1, count=2),
         span("detect.upload", 610, 700, 0),
         span("model.forward", 700, 1000, 0),
         span("detect.head", 1000, 1100, 0),
         span("detect.readback", 1100, 1390, 0),
         # another thread, with no detect root: not the detecting thread
         span("detect.upload", 1400, 1500, -1, thread=9, call=1)]
OPS = [("Memcpy HtoD (Pageable -> Device)", 650, 680), ("conv", 720, 800),
       ("bn", 790, 900), ("nms_tiled_kernel", 1050, 1060), ("Memcpy DtoH", 1150, 1380)]
HOST = [("cudaMemcpyAsync", 615, 690), ("cudaLaunchKernel", 710, 712),
        ("cudaLaunchKernel", 720, 722), ("cuLaunchKernelEx", 730, 732),
        ("cudaLaunchKernelExC", 1010, 1012), ("cudaLaunchKernel", 1020, 1022),
        ("cudaMemcpyAsync", 1150, 1160), ("cudaStreamSynchronize", 1160, 1385),
        ("cudaLaunchKernel", 1450, 1452), ("cudaDeviceSynchronize", 1490, END_US),
        ("cudaDeviceSynchronize", 1505, 1510)]


def make_run(spans=SPANS, host=HOST, monkeypatch=None):
    tr = Trace()
    tr.ops, tr.host, tr.window_s, tr._t0 = list(OPS), list(host), WINDOW_S, T0_S
    tr.images, tr.batches = 2, 1
    rec = Recording(list(spans), 0, REAL_OFF)
    monkeypatch.setattr(_spans, "_drain", lambda: rec)
    return harness.RunRecord(cell=types.SimpleNamespace(root=REPO), trace=tr, stats={},
                             untraced_images_per_s=None, traced_refs=[], head=None,
                             check_device=None)


def test_innermost_splits_nested_spans():
    got = _spans.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (7, 8, "d"),
                            (12, 13, "e")])
    assert got == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 7, "a"), (7, 8, "d"),
                   (8, 10, "a"), (12, 13, "e")]


def test_idle_partition_sums_to_the_idle_share(monkeypatch):
    run = make_run(monkeypatch=monkeypatch)
    got = {p: harness.read_metric(f"idle_pct.{p}", run)
           for p in ("upload", "launch", "readback", "caller")}
    # [500, 650] idle: 100 µs under no span, 10 under detect alone, 40 in upload;
    # [680, 720]: 20 upload, 20 forward; [900, 1050]: 100 forward, 50 head;
    # [1060, 1150]: 40 head, 50 readback; [1380, 1500]: 10 readback, 10 detect,
    # 100 under no span (thread 9's span is not the detecting thread's)
    assert got == pytest.approx({"upload": 6.0, "launch": 23.0, "readback": 6.0,
                                 "caller": 20.0})
    assert sum(got.values()) == pytest.approx(harness.read_metric("idle_pct.batch", run))


def test_spans_outside_the_stretch_are_left_out(monkeypatch):
    """A profiler session before the stretch may leave spans behind."""
    stale = [span("detect", 100, 300, -1, count=8), span("model.forward", 120, 290, 0)]
    run = make_run(spans=stale + SPANS, monkeypatch=monkeypatch)
    assert harness.read_metric("model.enqueue_ms", run) == pytest.approx(0.300 / 2)
    assert _spans.placed(run).images == 2


def test_a_gap_under_no_span_goes_to_the_caller(monkeypatch):
    root_only = [span("detect", 1000, 1010, -1, count=2)]
    run = make_run(spans=root_only, monkeypatch=monkeypatch)
    split = _spans.idle_split_s(run)
    assert split["launch"] == pytest.approx(10e-6) and split["upload"] == 0
    assert split["caller"] == pytest.approx(550e-6 - 10e-6)


def test_host_ms_and_launches_an_image(monkeypatch):
    run = make_run(monkeypatch=monkeypatch)
    assert harness.read_metric("model.launches", run) == pytest.approx(3 / 2)
    assert harness.read_metric("model.enqueue_ms", run) == pytest.approx(0.300 / 2)
    assert harness.read_metric("detect.upload_ms", run) == pytest.approx(0.090 / 2)
    names = {n for _, _, n in _spans.placed(run).spans}
    assert _spans.launches_in(_spans.placed(run), names) == (5, 6)


def test_the_window_ends_at_the_first_synchronise_after_the_last_launch():
    tr = Trace()
    tr.host = HOST
    assert _spans.window_end_us(tr) == END_US
    tr.host = [h for h in HOST if h[0] != "cudaDeviceSynchronize"]
    assert _spans.window_end_us(tr) is None


NAMES = ("idle_pct.upload", "idle_pct.launch", "idle_pct.readback", "idle_pct.caller",
         "detect.upload_ms", "model.enqueue_ms", "model.launches")


@pytest.mark.parametrize("name", NAMES)
def test_every_reader_returns_none_without_spans(name, monkeypatch):
    assert harness.read_metric(name, make_run(spans=[], monkeypatch=monkeypatch)) is None
    no_anchor = [h for h in HOST if h[0] != "cudaDeviceSynchronize"]
    assert harness.read_metric(name, make_run(host=no_anchor, monkeypatch=monkeypatch)) is None
    run = make_run(monkeypatch=monkeypatch)
    run.trace = None
    assert harness.read_metric(name, run) is None


@pytest.mark.parametrize("name", NAMES)
def test_every_reader_returns_none_where_the_program_has_no_recorder(name, monkeypatch):
    """A checkout of the program without fdt_torch.utils.trace."""
    run = make_run(monkeypatch=monkeypatch)
    monkeypatch.undo()
    monkeypatch.delattr(fdt_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "fdt_torch.utils.trace", None)
    assert _spans._drain() is None
    assert harness.read_metric(name, run) is None
