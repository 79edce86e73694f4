"""Fused video tracking: detect → rows → greedy association with one host
read a chunk of frames (counterpart of fdt/track/fused.py:41-235).

The unfused pipeline reads the detection tensor back to the host, converts
it with `detections_to_rows` and uploads the rows for the association.  Here
the chunk stays on the card: the detector's `detect_device` gives the
[F, 2, top_k, 5] tensor, a plain torch post re-expresses
`detections_to_rows` on it (the prefix-take at the score floor, pixel
scaling, the [[0, 0, 0, 0, 0.4]] sentinel of a frame with no rows), the
association kernel K3 runs the chunk in one launch, and one packed float32
tensor goes to pinned host memory by an asynchronous copy.  The host waits
on that copy's CUDA event, the one blocking read a chunk, so throughput
follows the card, not the round trips.

The video entry point (`track_video_fused`, which decodes with cv2) is not
ported yet.
"""
from __future__ import annotations

from collections import deque
from typing import List

import numpy as np
import torch

from fdt_torch.config import TRACKER, TrackerConfig
from fdt_torch.track.device_tracker import DeviceIoUTracker


class FusedVideoTracker(DeviceIoUTracker):
    """DeviceIoUTracker that also owns the detector: feed it raw frames.

    Args:
      detector: a fdt_torch.infer.PyramidBoxDetector; the tracker runs on its
        device.
      cfg: tracker thresholds (score_floor is the row-conversion threshold,
        exactly `track_video`'s `detect_threshold`).
      det_cap: per-frame detection budget entering the association.  Rows are
        score-sorted by NMS, so a cap keeps the TOP det_cap: equal to the
        host path whenever fewer than det_cap rows pass the floor (and to its
        `rows[:det_cap]` always).  Defaults to the detector's top_k.
      threshold / nms_thresh: the detect's conf/NMS thresholds; default to
        the detector's DetectConfig, as `detect_tensor`.
      lookahead: chunks in flight at most (default 1: the next chunk is
        queued before the last one is read).  With lookahead > 0 the
        host-visible state (`finished`, `frame_num`, histories) lags the last
        step_frames call by up to `lookahead` chunks; pass 0 to read it
        between chunks, or call flush() first.
    """

    def __init__(self, detector, cfg: TrackerConfig = TRACKER,
                 det_cap: int | None = None, threshold: float | None = None,
                 nms_thresh: float | None = None, t_max: int = 256,
                 lookahead: int = 1):
        self.detector = detector
        top_k = detector.cfg.detect.top_k
        self.det_cap = top_k if det_cap is None else int(det_cap)
        if not 0 < self.det_cap <= top_k:
            raise ValueError(f"det_cap must be in (0, {top_k}] (detector top_k); "
                             f"got {det_cap}")
        self.conf_thresh = (detector.cfg.detect.conf_thresh
                            if threshold is None else threshold)
        self.nms_thresh = (detector.cfg.detect.nms_thresh
                           if nms_thresh is None else nms_thresh)
        if cfg.score_floor <= 0:
            # detections_to_rows walks the all-zero class-0 rows when the
            # floor is <= 0 (a My_test.py quirk); the post takes class 1 only
            raise ValueError("FusedVideoTracker requires score_floor > 0")
        super().__init__(cfg, t_max=t_max, pad_n=self.det_cap, device=detector.device)
        self.lookahead = int(lookahead)
        # (packed host tensor, its copy's event or None, f, cap, t, pre-chunk slots)
        self._pending: deque = deque()
        # [w, h, w, h] on the device by frame size: a tensor made a chunk would
        # copy from pageable memory, which waits for the stream to drain
        self._scales: dict[tuple[int, int], torch.Tensor] = {}

    def _post(self, det: torch.Tensor, slots, width: int, height: int):
        """[F, 2, top_k, 5] detections and the slot state → (new slots, the
        packed [F, 5 cap + 2 T + cap + 2] float32 records).  No host read."""
        scale = self._scales.get((width, height))
        if scale is None:
            scale = self._scales[(width, height)] = torch.tensor(
                [width, height, width, height], dtype=torch.float32, device=self.device)
        cap, floor = self.det_cap, self.cfg.score_floor
        f = det.shape[0]
        cls1 = det[:, 1, :cap, :]
        scores = cls1[..., 0]
        # prefix-take at the floor = detections_to_rows' cumprod walk
        ok = torch.cumprod((scores >= floor).to(torch.int32), dim=1).bool()
        boxes = cls1[..., 1:5] * scale
        # a frame with no rows → the [[0, 0, 0, 0, 0.4]] sentinel row
        first = torch.arange(cap, device=det.device) == 0
        sentinel = ~ok[:, :1] & first
        scores = torch.where(sentinel, 0.4, scores)
        boxes = torch.where(sentinel[..., None], 0.0, boxes)
        valid = ok | sentinel
        slots, assign, finish, spawn, overflow = self._associate(
            slots, boxes.contiguous(), scores.contiguous(), valid)
        rows = torch.cat([boxes, scores[..., None]], dim=-1)
        # one packed float32 tensor → one host read a chunk; float32 holds the
        # integer fields exactly (indices < cap, slot ids < t_max, << 2^24)
        packed = torch.cat([rows.reshape(f, cap * 5), assign.float(), finish.float(),
                            spawn.float(), valid.sum(dim=1, dtype=torch.float32)[:, None],
                            overflow.float()[:, None]], dim=1)
        return slots, packed

    def step_frames(self, frames_u8) -> None:
        """Advance F frames from a [F, H, W, 3] uint8 BGR chunk (numpy array
        or tensor).

        Queues the detect, the post and K3 on the current stream and the
        packed records' copy to pinned host memory; up to `lookahead` chunks
        stay in flight, replayed in order by the next step_frames or flush.
        Do not interleave with the inherited step()/step_chunk() row API,
        which would reorder against chunks in flight."""
        if not torch.is_tensor(frames_u8):
            frames_u8 = torch.from_numpy(np.ascontiguousarray(frames_u8))
        f, h, w, _ = frames_u8.shape
        det = self.detector.detect_device(frames_u8, self.conf_thresh, self.nms_thresh)
        pre_slots = self.slots
        self.slots, packed = self._post(det, pre_slots, w, h)
        event = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            packed = host
        self._pending.append((packed, event, f, self.det_cap, self.t_max, pre_slots))
        while len(self._pending) > self.lookahead:
            self._drain_one()

    @staticmethod
    def _parse(packed: np.ndarray, f: int, cap: int, t: int):
        rows = packed[:, :cap * 5].reshape(f, cap, 5)
        assign = packed[:, cap * 5:cap * 5 + t].astype(np.int32)
        finish = packed[:, cap * 5 + t:cap * 5 + 2 * t] > 0.5
        spawn = packed[:, cap * 5 + 2 * t:cap * 5 + 2 * t + cap].astype(np.int32)
        count = packed[:, -2].astype(np.int32)
        overflow = packed[:, -1]
        return rows, assign, finish, spawn, count, overflow

    @staticmethod
    def _read(packed: torch.Tensor, event) -> np.ndarray:
        if event is not None:
            event.synchronize()  # the one blocking read of a chunk
        return packed.numpy()

    def _drain_one(self) -> None:
        packed, event, f, cap, t, pre_slots = self._pending.popleft()
        rows, assign, finish, spawn, count, overflow = self._parse(
            self._read(packed, event), f, cap, t)
        if overflow.sum():
            # slots ran out mid-chunk (rare): every chunk queued after this
            # one ran its association against overflowed state, so recompute
            # them all, in order, from their rows already read (no second
            # detect), then restart the pipeline
            self._redo_overflow(pre_slots, [(rows, count, f, cap)])
            return
        self._replay([rows[i, :count[i]] for i in range(f)], assign, finish, spawn)

    def _redo_overflow(self, pre_slots, chunks) -> None:
        for packed, event, f, cap, _, _ in self._pending:  # rows do not depend on slots
            p = self._read(packed, event)
            chunks.append((p[:, :cap * 5].reshape(f, cap, 5), p[:, -2].astype(np.int32),
                           f, cap))
        self._pending.clear()
        slots = pre_slots
        for k, (rows, count, f, cap) in enumerate(chunks):
            if k == 0:
                # this chunk overflowed at the current capacity: grow first
                # (the chunks after it try their state's size first)
                self.t_max = max(self.t_max, slots.alive.shape[0] * 2)
            boxes = torch.from_numpy(np.ascontiguousarray(rows[..., :4])).to(self.device)
            scores = torch.from_numpy(np.ascontiguousarray(rows[..., 4])).to(self.device)
            valid = torch.from_numpy(np.arange(cap) < count[:, None]).to(self.device)
            while True:
                if slots.alive.shape[0] < self.t_max:
                    slots = self._grow(slots, self.t_max)
                    self._hist += [None] * (self.t_max - len(self._hist))
                new_slots, assign, finish, spawn, overflow = self._associate(
                    slots, boxes, scores, valid)
                if not int(overflow.sum()):
                    break
                self.t_max *= 2
            slots = new_slots
            self._replay([rows[i, :count[i]] for i in range(f)], assign.cpu().numpy(),
                         finish.cpu().numpy(), spawn.cpu().numpy())
        self.slots = slots

    def flush(self) -> List[dict]:
        while self._pending:  # drain the pipeline
            self._drain_one()
        return super().flush()
