"""Micro-batching inference serving (counterpart of fdt/apps/serving.py:41-301,
the "pyramidbox", "facebox" and "mtcnn" families; and "retinaface", which
fdt does not have).

  MicroBatcher       background daemon worker coalescing concurrent requests
                     into batches (the first request opens a window of
                     `max_wait_ms`; everything that arrives before it closes,
                     up to `max_batch`, rides the same device dispatch),
                     resolving per-request futures and relaying per-batch
                     errors.  close() drains the queue and joins the worker.
                     stats() is the operator's view (GET /healthz): requests,
                     batches, mean and max batch size, queue_wait_ms_mean /
                     queue_wait_ms_max (a request's wait from submit() to the
                     start of the batch it rode) and worker_busy_share (the
                     worker's seconds in batch_fn over its lifetime so far).
  DetectionService   resizes requests to the service frame size on the host,
                     runs the batch at its own size (eager PyTorch compiles
                     nothing per batch size, so fdt's power-of-two bucket
                     padding would only add work), and maps boxes back to
                     each request's pixels.
  make_http_server   stdlib ThreadingHTTPServer front end: POST /detect with
                     encoded image bytes → JSON detection rows; GET /healthz
                     with the service's and the batcher's stats.  Every
                     handler thread funnels into the one MicroBatcher, so
                     HTTP concurrency becomes device batch size.  Bodies are
                     decoded by fdt_torch.data.image_io (PNG by the port
                     itself, other formats through Pillow) in place of
                     cv2.imdecode.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.infer.pyramidbox import detections_to_rows
from fdt_torch.infer.retinaface import landmark_rows_of

FAMILIES = ("pyramidbox", "facebox", "mtcnn", "retinaface")
_SENTINEL = object()


class _Call:
    """A queue item that runs a function on the worker instead of a request."""

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn


class MicroBatcher:
    """Coalesce concurrent `submit` calls into list-batched `batch_fn` calls.

    batch_fn(items: list) -> sequence of per-item results (same length/order).
    A batch_fn exception fails every future of that batch; the worker keeps
    serving subsequent batches.
    """

    def __init__(self, batch_fn: Callable[[list], Sequence],
                 max_batch: int = 32, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.requests = 0
        self.batches = 0
        self._size_sum = 0
        self._size_max = 0
        self._waited = 0       # requests that rode a batch
        self._wait_sum = 0.0   # their seconds from submit to their batch's start
        self._wait_max = 0.0
        self._busy_s = 0.0     # the worker's seconds in batch_fn
        self._t_start = time.monotonic()
        self._t_end = None     # when the worker returned
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="fdt-torch-microbatcher")
        self._worker.start()

    def submit(self, item) -> Future:
        """Enqueue one request; returns a Future resolving to its result."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self.requests += 1
            self._q.put((fut, item, time.monotonic()))
        return fut

    def call(self, fn: Callable[[], object]) -> Future:
        """Run fn() on the worker thread, alone and between batches; returns
        a Future of its result.  It counts as no request and no batch.  What
        PyTorch keeps for each thread, such as the cuDNN plans it has built
        for each convolution shape, is then the worker's own."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((fut, _Call(fn)))
        return fut

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain in-flight ones, join the worker.

        If the worker does not finish within `timeout` seconds (stuck in a
        long batch), still-queued futures are failed instead of left pending
        forever: a caller blocked in fut.result() gets an error, not a hang."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_SENTINEL)
        self._worker.join(timeout)
        if self._worker.is_alive():
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL and not item[0].done():
                    item[0].set_exception(
                        RuntimeError("MicroBatcher closed before this "
                                     "request was served"))
            # the drain took the sentinel too: put it back, so that the
            # worker still ends when its batch returns (fdt's close leaves
            # that worker blocked on the empty queue)
            self._q.put(_SENTINEL)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        n, waited = self.batches, self._waited
        lifetime = (self._t_end or time.monotonic()) - self._t_start
        return {"requests": self.requests, "batches": n,
                "max_batch_size": self._size_max,
                "mean_batch_size": (self._size_sum / n) if n else 0.0,
                "queue_wait_ms_mean": 1e3 * self._wait_sum / waited if waited else 0.0,
                "queue_wait_ms_max": 1e3 * self._wait_max,
                "worker_busy_share": self._busy_s / lifetime if lifetime > 0 else 0.0}

    def _run(self) -> None:
        try:
            self._serve()
        finally:
            self._t_end = time.monotonic()

    def _serve(self) -> None:
        while True:
            first = self._q.get()
            if first is _SENTINEL:
                return
            if isinstance(first[1], _Call):
                self._call(*first)
                continue
            batch, call = [first], None
            stop = False
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    stop = True
                    break
                if isinstance(item[1], _Call):  # it runs after this batch
                    call = item
                    break
                batch.append(item)
            # claim every future first: a client-cancelled future then cannot
            # make set_result raise mid-loop and poison the rest of the batch
            live = [(f, it, t) for f, it, t in batch
                    if f.set_running_or_notify_cancel()]
            futures = [f for f, _, _ in live]
            if futures:
                t_batch = time.monotonic()
                for *_, t in live:
                    self._wait_sum += t_batch - t
                    self._wait_max = max(self._wait_max, t_batch - t)
                self._waited += len(live)
                try:
                    results = self._batch_fn([it for _, it, _ in live])
                    if len(results) != len(futures):
                        raise RuntimeError(
                            f"batch_fn returned {len(results)} results for "
                            f"{len(futures)} items")
                    for fut, res in zip(futures, results):
                        fut.set_result(res)
                except Exception as e:  # noqa: BLE001 — relay to the callers
                    for fut in futures:
                        if not fut.done():
                            fut.set_exception(e)
                finally:
                    self._busy_s += time.monotonic() - t_batch
            self.batches += 1
            self._size_sum += len(futures)
            self._size_max = max(self._size_max, len(futures))
            if call is not None:
                self._call(*call)
            if stop:
                return

    @staticmethod
    def _call(fut: Future, call: _Call) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(call.fn())
        except Exception as e:  # noqa: BLE001 — relay to the caller
            fut.set_exception(e)


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H,W,3] uint8 → [height,width,3] uint8, bilinear with half-pixel
    centres and no antialiasing, rounded to nearest: within 1 LSB of
    cv2.resize(INTER_LINEAR), whose fixed-point weights round differently."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


class DetectionService:
    """Batched detection serving over one detector family.

    family: "pyramidbox" (a PyramidBoxDetector of any variant, frames of
    `frame_size`), "facebox" (a FaceBoxDetector; frames are its config's
    fixed square input, whatever `frame_size` says) or "mtcnn" (an
    MTCNNDeviceCascade, frames of `frame_size`) or "retinaface" (a
    RetinaFaceDetector, frames of `frame_size`).  Requests are BGR uint8
    images of ANY resolution; results are [N, 5] float32 rows
    [x1, y1, x2, y2, score] in the REQUEST's pixel coordinates (empty [0, 5]
    when nothing is detected: serving drops the eval protocol's
    [[0, 0, 0, 0, 0.4]] sentinel).  For mtcnn and retinaface the rows are
    [N, 15]: box and score, then the 10 landmark coordinates (x, y of each
    of 5 points).
    """

    def __init__(self, family: str, detector, frame_size=(640, 480),
                 threshold: float = 0.4, nms_thresh: float = 0.35,
                 max_batch: int = 32, max_wait_ms: float = 5.0):
        if family not in FAMILIES:
            raise ValueError(f"unknown family: {family!r} (this port serves "
                             f"{', '.join(map(repr, FAMILIES))})")
        self.family = family
        self.detector = detector
        if family == "facebox":  # fixed square input
            s = detector.cfg.input_size
            frame_size = (s, s)
        self.frame_w, self.frame_h = frame_size
        self.threshold = threshold
        self.nms_thresh = nms_thresh
        # serialises _run_batch between the batcher's worker and any other
        # caller: the detectors' per-shape LRUs are not safe under concurrent
        # mutation (warmup() runs on the worker itself)
        self._infer_lock = threading.Lock()
        self.batcher = MicroBatcher(self._run_batch, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)

    def submit(self, image_bgr: np.ndarray) -> Future:
        if image_bgr.ndim != 3 or image_bgr.shape[2] != 3:
            raise ValueError(f"expected HxWx3 BGR image, got {image_bgr.shape}")
        return self.batcher.submit(np.asarray(image_bgr, np.uint8))

    def detect(self, image_bgr: np.ndarray) -> np.ndarray:
        """Blocking single-request detect (rides a shared batch)."""
        return self.submit(image_bgr).result()

    def warmup(self) -> None:
        """Cut the first requests' latency: build and load the kernel library
        on the card, then run frames of the service's size at every batch
        size from 1 to max_batch, on the batcher's worker thread.  The port
        pads no batch to a bucket, so the batcher may form any of them; the
        first call of each pays cuDNN's set-up for its shapes, and PyTorch
        keeps what that set-up builds for each thread apart, so a warmup on
        the caller's thread would leave the worker cold."""
        if self.detector.device.type == "cuda":
            from fdt_torch.ops import _build
            _build.library()
        frame = np.zeros((self.frame_h, self.frame_w, 3), np.uint8)
        for n in range(1, self.batcher.max_batch + 1):
            self.batcher.call(lambda n=n: self._run_batch([frame] * n)).result()

    def stats(self) -> dict:
        return {"family": self.family,
                "frame_size": [self.frame_w, self.frame_h],
                "threshold": self.threshold, **self.batcher.stats()}

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run_batch(self, images: list[np.ndarray]) -> list[np.ndarray]:
        sizes = [(im.shape[1], im.shape[0]) for im in images]  # (w, h)
        frames = np.stack(
            [im if im.shape[:2] == (self.frame_h, self.frame_w)
             else resize_bilinear(im, self.frame_w, self.frame_h)
             for im in images])
        with self._infer_lock:
            return self._detect_rows(frames, sizes)

    def _detect_rows(self, frames: np.ndarray, sizes: list) -> list[np.ndarray]:
        if self.family == "facebox":
            return [self._facebox_rows(b, s, *size) for (b, s), size
                    in zip(self.detector.detect_batch(frames), sizes)]
        if self.family == "mtcnn":
            boxes, lms, counts, _ = self.detector.detect_batch(frames)
            return [self._mtcnn_rows(boxes[i, :c], lms[i, :c], *size)
                    for i, (c, size) in enumerate(zip(counts, sizes))]
        det = self.detector.detect_tensor(frames, conf_thresh=self.threshold,
                                          nms_thresh=self.nms_thresh)
        if self.family == "retinaface":  # normalized rows, scaled to each request's size
            return [landmark_rows_of(d, self.threshold, w, h) for d, (w, h) in zip(det, sizes)]
        return [self._pyramidbox_rows(d, *size) for d, size in zip(det, sizes)]

    def _pyramidbox_rows(self, det: np.ndarray, w: int, h: int) -> np.ndarray:
        r = detections_to_rows(det, self.threshold, [w, h, w, h])
        if r.shape == (1, 5) and not r[0, :4].any():  # empty sentinel
            return np.empty((0, 5), np.float32)
        return r.astype(np.float32)

    def _facebox_rows(self, boxes: np.ndarray, scores: np.ndarray, w: int,
                      h: int) -> np.ndarray:
        """The detector's own thresholds apply; serving keeps the rows with
        score >= threshold, in pixels."""
        keep = scores >= self.threshold
        px = boxes[keep] * np.array([w, h, w, h], np.float32)
        return np.column_stack([px, scores[keep]]).astype(np.float32)

    def _mtcnn_rows(self, boxes: np.ndarray, lms: np.ndarray, w: int, h: int) -> np.ndarray:
        """fdt's _rows_mtcnn: boxes and landmarks scaled from the frame to the
        request's pixels; rows with score >= threshold."""
        sx, sy = w / self.frame_w, h / self.frame_h
        b = boxes.copy()
        b[:, [0, 2]] *= sx
        b[:, [1, 3]] *= sy
        lm = lms.copy()
        lm[:, 0::2] *= sx
        lm[:, 1::2] *= sy
        keep = b[:, 4] >= self.threshold
        return np.column_stack([b[keep], lm[keep]]).astype(np.float32).reshape(-1, 15)


# -- HTTP front end -----------------------------------------------------------


def make_http_server(service: DetectionService, host: str = "127.0.0.1",
                     port: int = 0, max_body_bytes: int = 64 << 20):
    """Build (do not start) a ThreadingHTTPServer around a DetectionService.

    POST /detect    body = an encoded image (PNG, or what Pillow reads) →
                    {"detections": [[x1, y1, x2, y2, score, ...], ...],
                    "count": n}.  Optional ?threshold=T post-filters rows by
                    score.  A body over `max_body_bytes` (64 MB by default)
                    gets 413 before it is read; an undecodable one, or a
                    Content-Length that is no count, 400; an exception 500.
    GET  /healthz   → {"status": "ok", ...service stats}.
    Any other path gets 404.

    The caller owns the lifecycle: server.serve_forever() (usually on a
    thread), then server.shutdown(), server.server_close(), service.close().
    """
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from fdt_torch.data.image_io import imdecode

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if urllib.parse.urlparse(self.path).path == "/healthz":
                self._reply(200, {"status": "ok", **service.stats()})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            url = urllib.parse.urlparse(self.path)
            if url.path != "/detect":
                self._reply(404, {"error": f"unknown path {url.path}"})
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = -1
                if length < 0:  # rfile.read(-1) would wait for the client to close
                    self._reply(400, {"error": "bad Content-Length"})
                    return
                if length > max_body_bytes:
                    self._reply(413, {"error": f"body {length} bytes exceeds "
                                               f"limit {max_body_bytes}"})
                    return
                img = imdecode(self.rfile.read(length))
                if img is None:
                    self._reply(400, {"error": "undecodable image payload"})
                    return
                rows = service.detect(img)
                q = urllib.parse.parse_qs(url.query)
                if "threshold" in q:
                    rows = rows[rows[:, 4] >= float(q["threshold"][0])]
                self._reply(200, {"detections": rows.tolist(),
                                  "count": int(len(rows))})
            except Exception as e:  # noqa: BLE001 — HTTP boundary
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(service: DetectionService, host: str = "127.0.0.1",
               port: int = 8000, max_body_bytes: int = 64 << 20) -> None:
    """Serve `service` over HTTP until interrupted, then close both."""
    server = make_http_server(service, host, port, max_body_bytes)
    print(f"fdt_torch serving {service.family} on "
          f"http://{host}:{server.server_address[1]} (frame {service.frame_w}x"
          f"{service.frame_h}, max_batch {service.batcher.max_batch}, "
          f"device {service.detector.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
