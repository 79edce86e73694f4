"""The IoU tracker whose association decisions run on the device
(counterpart of fdt/track/device_tracker.py:197-315).

The association scan (fdt_torch.geometry.track, kernel K3 on the card via
fdt_torch.ops.track.associate_chunk) emits one small record a frame; the
host replays the records to rebuild the box histories, so it does no IoU
arithmetic and reads the device once a chunk.

The host tracker's three quirks hold (a frame with no rows drops every track
silently; an unmatched track finishes only with len > t_min; the flush takes
len >= t_min).  The only divergence from fdt.track.iou_tracker is float32
against its float64 at exact threshold boundaries.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fdt_torch.config import TRACKER, TrackerConfig
from fdt_torch.geometry.track import _DEAD_ORDER, _Slots, init_slots
from fdt_torch.infer.pyramidbox import _resolve_device
from fdt_torch.ops.track import associate_chunk


class DeviceIoUTracker:
    """Tracker whose association decisions run on the device (kernel K3 on
    the card, its plain version on the CPU).

    Same step()/flush() contract and output schema as IoUTracker; feed
    frames in chunks for throughput (step_chunk) or one at a time (step).
    `device`: None → "cuda" (raises if absent); "cpu" for the CPU.
    """

    def __init__(self, cfg: TrackerConfig = TRACKER, t_max: int = 256,
                 pad_n: int = 64, device=None):
        self.cfg = cfg
        self.t_max = t_max
        self.pad_n = pad_n
        self.device = _resolve_device(device)
        self.slots = init_slots(t_max, self.device)
        self.frame_num = 0
        # host-side mirrors, indexed by slot
        self._hist: List[dict | None] = [None] * t_max
        self.finished: List[dict] = []

    def _pad(self, rows_list: Sequence[np.ndarray]):
        """[F, N, 4] boxes, [F, N] scores and valid on the device, N the pad
        width: pad_n doubled until every frame's rows fit, and kept."""
        n = self.pad_n
        need = max([1] + [len(r) for r in rows_list])
        while n < need:
            n *= 2
        self.pad_n = n  # a chunk after keeps the width
        f = len(rows_list)
        boxes = np.zeros((f, n, 4), np.float32)
        scores = np.zeros((f, n), np.float32)
        valid = np.zeros((f, n), bool)
        for i, rows in enumerate(rows_list):
            rows = np.asarray(rows, np.float32).reshape(-1, 5)
            boxes[i, :len(rows)] = rows[:, :4]
            scores[i, :len(rows)] = rows[:, 4]
            valid[i, :len(rows)] = True
        return tuple(torch.from_numpy(a).to(self.device) for a in (boxes, scores, valid))

    @staticmethod
    def _grow(slots: _Slots, t_max: int) -> _Slots:
        """Copy slot state into larger buffers (track-count auto-scaling)."""
        pad = t_max - slots.alive.shape[0]
        return _Slots(last_box=F.pad(slots.last_box, (0, 0, 0, pad)),
                      max_score=F.pad(slots.max_score, (0, pad)),
                      length=F.pad(slots.length, (0, pad)),
                      order=F.pad(slots.order, (0, pad), value=_DEAD_ORDER),
                      alive=F.pad(slots.alive, (0, pad)),
                      next_key=slots.next_key)

    def _associate(self, slots, boxes, scores, valid):
        return associate_chunk(slots, boxes, scores, valid, self.cfg)

    def step_chunk(self, rows_list: Sequence[np.ndarray]) -> None:
        """Advance len(rows_list) frames; each entry is an [N,5] rows array."""
        boxes, scores, valid = self._pad(rows_list)
        while True:
            new_slots, assign, finish, spawn, overflow = self._associate(
                self.slots, boxes, scores, valid)
            if not int(overflow.sum()):
                break
            # slots exhausted mid-chunk: double the capacity and re-run the
            # chunk from the unmodified pre-chunk state (the host tracker is
            # unbounded, so capacity must never change results)
            self.t_max *= 2
            self.slots = self._grow(self.slots, self.t_max)
            self._hist += [None] * (self.t_max - len(self._hist))
        self.slots = new_slots
        self._replay(rows_list, assign.cpu().numpy(), finish.cpu().numpy(),
                     spawn.cpu().numpy())

    def _replay(self, rows_list: Sequence[np.ndarray], assign: np.ndarray,
                finish: np.ndarray, spawn: np.ndarray) -> None:
        """Rebuild the host-side box histories from the device records."""
        for f in range(len(rows_list)):
            self.frame_num += 1
            rows = np.asarray(rows_list[f], np.float32).reshape(-1, 5)
            # replay in creation order = the reference's list order
            live = [s for s in range(self.t_max) if self._hist[s] is not None]
            for s in sorted(live, key=lambda s: self._hist[s]["_key"]):
                d = assign[f, s]
                if d >= 0:
                    t = self._hist[s]
                    t["bboxes"].append(list(map(float, rows[d, :4])))
                    t["max_score"] = max(t["max_score"], float(rows[d, 4]))
                elif finish[f, s]:
                    t = self._hist[s]
                    del t["_key"]
                    self.finished.append(t)
                    self._hist[s] = None
                else:
                    self._hist[s] = None  # discarded or silently dropped
            for d in range(len(rows)):
                s = spawn[f, d]
                if s >= 0:
                    self._hist[s] = {"bboxes": [list(map(float, rows[d, :4]))],
                                     "max_score": float(rows[d, 4]),
                                     "start_frame": self.frame_num,
                                     "_key": (self.frame_num, d)}

    def step(self, det_rows: np.ndarray) -> None:
        self.step_chunk([np.asarray(det_rows)])

    def flush(self) -> List[dict]:
        """Final flush (iouTracke_cal.py:174-175): len >= t_min, active order.

        Like IoUTracker.flush, leaves the tracker empty but usable: the
        device slots reset with the host mirrors, so later steps start from
        scratch instead of matching against ghost slots."""
        live = [s for s in range(self.t_max) if self._hist[s] is not None]
        for s in sorted(live, key=lambda s: self._hist[s]["_key"]):
            t = self._hist[s]
            if (t["max_score"] > self.cfg.sigma_h
                    and len(t["bboxes"]) >= self.cfg.t_min):
                del t["_key"]
                self.finished.append(t)
            self._hist[s] = None
        self.slots = init_slots(self.t_max, self.device)
        return self.finished
