"""The port's HTTP front end (fdt_torch.apps.serving.make_http_server) against
fdt's (fdt/apps/serving.py:305-368) on the same PNG bodies and the same
depth-cut flagship (the first block of every ResNet stage of
net_weight/repo_mini.npz), and the serving details the slice adds:
404/400/413/500, ?threshold=, /healthz, warmup(), _infer_lock and
MicroBatcher.close(timeout=)."""
import http.client
import json
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.apps.serving import DetectionService as JaxService  # noqa: E402
from fdt.apps.serving import make_http_server as jax_http_server  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox  # noqa: E402
from fdt_torch.apps.serving import DetectionService, MicroBatcher, make_http_server  # noqa: E402
from fdt_torch.infer import PyramidBoxDetector, detections_to_rows  # noqa: E402
from fdt_torch.models import PyramidBox, from_jax_variables, load_npz  # noqa: E402
from tests.test_torch_detector import CUT, _first_blocks  # noqa: E402

torch.set_num_threads(1)

WEIGHTS = REPO / "net_weight" / "repo_mini.npz"
H, W = 64, 96  # the service's frame; requests arrive at this size
THRESHOLD = 0.1


@pytest.fixture(scope="module")
def cut_variables():
    return _first_blocks(load_npz(str(WEIGHTS)))


@pytest.fixture(scope="module")
def port_detector(cut_variables):
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(cut_variables), strict=True)
    return PyramidBoxDetector(model, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(6)]


class _Server:
    """A started HTTP server around a service, stopped on exit."""

    def __init__(self, make, service, **kw):
        self.service = service
        self.server = make(service, port=0, **kw)
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(30)
        assert not self.thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rows(payload):
    return np.asarray(payload["detections"], np.float32).reshape(-1, 5)


def _direct(det, frame):
    r = detections_to_rows(det.detect_tensor(frame[None], THRESHOLD, 0.35)[0], THRESHOLD,
                           [W, H, W, H])
    return np.empty((0, 5), np.float32) if not r[:, :4].any() else r.astype(np.float32)


def _service(det, **kw):
    return DetectionService("pyramidbox", det, frame_size=(W, H), threshold=THRESHOLD,
                            nms_thresh=0.35, **kw)


def test_port_and_fdt_servers_give_the_same_rows(port_detector, cut_variables, frames):
    """Same PNG bodies, one at a time (fdt compiles one batch bucket):
    rows within 1e-5 of the frame size, as tests/test_torch_detector.py."""
    jdet = JaxDetector(cut_variables, JaxPyramidBox(num_blocks=CUT), "repo",
                       precision="highest")
    bodies = [chip_smoke.encode_png(f, k % 5) for k, f in enumerate(frames[:3])]
    answers = []
    for make, svc in ((make_http_server, _service(port_detector, max_batch=2)),
                      (jax_http_server, JaxService("pyramidbox", jdet, frame_size=(W, H),
                                                   threshold=THRESHOLD, nms_thresh=0.35,
                                                   max_batch=2))):
        with _Server(make, svc) as s:
            answers.append([_post(f"{s.url}/detect", b) for b in bodies])
    total = 0
    for (code, ours), (jcode, theirs) in zip(*answers):
        assert code == jcode == 200 and ours["count"] == theirs["count"]
        np.testing.assert_allclose(_rows(ours), _rows(theirs), rtol=0, atol=1e-5 * W)
        total += ours["count"]
    assert total > 20


def test_http_contract(port_detector, frames):
    body = chip_smoke.encode_png(frames[0])
    want = _direct(port_detector, frames[0])
    assert len(want) > 4
    with _Server(make_http_server, _service(port_detector, max_batch=2),
                 max_body_bytes=1 << 20) as s:
        code, payload = _post(f"{s.url}/detect", body)
        assert code == 200 and payload["count"] == len(want)
        np.testing.assert_allclose(_rows(payload), want, rtol=0, atol=1e-4)
        cut = float(np.median(want[:, 4]))
        code, payload = _post(f"{s.url}/detect?threshold={cut}", body)
        np.testing.assert_allclose(_rows(payload), want[want[:, 4] >= cut], rtol=0, atol=1e-4)
        assert 0 < payload["count"] < len(want)
        with urllib.request.urlopen(f"{s.url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["family"] == "pyramidbox"
        assert health["requests"] == 2 and health["frame_size"] == [W, H]
        assert _post(f"{s.url}/detect", b"not an image")[0] == 400
        assert _post(f"{s.url}/other", body)[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{s.url}/nope", timeout=60)
        assert e.value.code == 404
        # a declared length over the limit: 413 before any body is read
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        for length in ("-1", "many"):
            conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
            conn.putrequest("POST", "/detect")
            conn.putheader("Content-Length", length)
            conn.endheaders()
            assert conn.getresponse().status == 400
            conn.close()


def test_http_500_on_a_detector_error(port_detector, frames):
    class Broken:
        device = torch.device("cpu")

        def detect_tensor(self, *a, **k):
            raise RuntimeError("boom")

    with _Server(make_http_server, DetectionService("pyramidbox", Broken(),
                                                    frame_size=(W, H))) as s:
        code, payload = _post(f"{s.url}/detect", chip_smoke.encode_png(frames[0]))
    assert code == 500 and "boom" in payload["error"]


def test_http_400_on_a_png_bomb_without_inflating_it(port_detector):
    """A PNG whose header is over cv2's pixel limit, on data that inflates to
    64 MB, inside the 1 MB body limit: 400, and the server allocates far less
    than the bomb would inflate to (fdt's cv2 server raises there: 500)."""
    from tests.test_torch_image_io import BOMB_MB, _peak_mb, _png_with_idat, deflate_bomb

    body = _png_with_idat(deflate_bomb(), 65536, 65536)
    assert len(body) < 1 << 20
    with _Server(make_http_server, _service(port_detector, max_batch=2),
                 max_body_bytes=1 << 20) as s:
        (code, payload), peak = _peak_mb(_post, f"{s.url}/detect", body)
        assert s.service.stats()["requests"] == 0
    assert code == 400 and "undecodable" in payload["error"]
    assert peak < BOMB_MB / 8, f"{peak:.1f} MB allocated while refusing the bomb"


def _burst(url, bodies, clients=3):
    results = {}

    def client(ids):
        for i in ids:
            results[i] = _post(url, bodies[i])

    threads = [threading.Thread(target=client, args=(range(k, len(bodies), clients),))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    return results


def test_warmup_then_a_burst_answers_as_without_warmup(port_detector, frames):
    bodies = [chip_smoke.encode_png(f) for f in frames]
    want = [_direct(port_detector, f) for f in frames]
    answers = []
    for warm in (False, True):
        svc = _service(port_detector, max_batch=4, max_wait_ms=30)
        with _Server(make_http_server, svc) as s:
            if warm:
                svc.warmup()
                assert svc.stats()["batches"] == 0  # warmup does not ride the batcher
            got = _burst(f"{s.url}/detect", bodies)
            assert svc.stats()["requests"] == len(bodies)
        answers.append(got)
    for i in range(len(bodies)):
        for got in answers:
            assert got[i][0] == 200
            # another batch size sums the convolutions in another order
            np.testing.assert_allclose(_rows(got[i][1]), want[i], rtol=0, atol=1e-4)


def test_warmup_runs_batch_one_and_max_batch(port_detector):
    sizes, threads = [], set()

    class Spy:
        device = torch.device("cpu")

        def detect_tensor(self, frames, **kw):
            sizes.append(frames.shape)
            threads.add(threading.current_thread())
            return port_detector.detect_tensor(frames, **kw)

    with DetectionService("pyramidbox", Spy(), frame_size=(W, H), max_batch=3) as svc:
        svc.warmup()
        assert threads == {svc.batcher._worker}  # the thread that serves batches
        assert svc.stats()["batches"] == svc.stats()["requests"] == 0
    assert sizes == [(n, H, W, 3) for n in (1, 2, 3)]  # every batch size


def test_infer_lock_serialises_batches(port_detector, frames):
    with _service(port_detector, max_batch=2, max_wait_ms=1) as svc:
        with svc._infer_lock:
            fut = svc.submit(frames[0])
            time.sleep(0.3)
            assert not fut.done()  # the worker waits for the lock
        assert fut.result(timeout=120).shape[1] == 5


def test_close_timeout_fails_queued_futures_when_the_worker_is_stuck():
    gate = threading.Event()

    def stuck(items):
        gate.wait(60)
        return items

    mb = MicroBatcher(stuck, max_batch=1, max_wait_ms=1)
    first = mb.submit(0)
    time.sleep(0.1)  # the worker is inside the first batch
    queued = [mb.submit(i) for i in (1, 2)]
    t = time.perf_counter()
    mb.close(timeout=0.2)
    assert time.perf_counter() - t < 10
    for f in queued:
        with pytest.raises(RuntimeError, match="closed before"):
            f.result(timeout=1)
    gate.set()
    assert first.result(timeout=30) == 0
    mb._worker.join(30)
    assert not mb._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(3)


def test_call_runs_on_the_worker_between_batches():
    """A call that arrives inside a batch's window closes the window: the
    batch runs, then the call, then the requests after it; a call's error
    reaches its caller and the worker serves on."""
    order = []

    def batch_fn(items):
        order.append(list(items))
        return items

    with MicroBatcher(batch_fn, max_batch=8, max_wait_ms=300) as mb:
        futs = [mb.submit(0), mb.submit(1)]
        call = mb.call(lambda: order.append(threading.current_thread()) or "done")
        futs.append(mb.submit(2))
        assert call.result(timeout=30) == "done"
        assert [f.result(timeout=30) for f in futs] == [0, 1, 2]
        failed = mb.call(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            failed.result(timeout=30)
        assert mb.submit(3).result(timeout=30) == 3
        assert mb.stats()["requests"] == 4 and mb.stats()["batches"] == 3
    assert order[:3] == [[0, 1], mb._worker, [2]]
    with pytest.raises(RuntimeError, match="closed"):
        mb.call(lambda: None)


def test_close_default_timeout_drains_the_queue():
    with MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=2, max_wait_ms=1) as mb:
        futs = [mb.submit(i) for i in range(5)]
    assert [f.result(timeout=1) for f in futs] == [1, 2, 3, 4, 5]
