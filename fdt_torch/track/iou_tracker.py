"""Offline multi-face IoU tracker on the host (copy of
fdt/track/iou_tracker.py:1-104,157-163).

Greedy association in the reference's order (iouTracke_cal.py:126-177), in
numpy float64, with its three quirks kept so that track IDs match:

  * a frame with ZERO detections silently DROPS every active track (neither
    extended nor finished: iouTracke_cal.py:130's `if len(dets) > 0` skips
    both branches);
  * an unmatched track finishes only if max_score > sigma_h AND
    len > t_min (strictly, line 147), while the final flush uses
    len >= t_min (line 175);
  * tracks are matched greedily in list order against their LAST box, and
    the matched detection leaves the pool (lines 132-145).

Track schema: {'bboxes': [[x1, y1, x2, y2], ...], 'max_score': float,
'start_frame': int}, saved with np.save(path, np.array(tracks)).

The video entry point (`track_video`, which decodes with cv2) is not ported yet.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from fdt_torch.config import TRACKER, TrackerConfig


def _iou_to_last(dets: np.ndarray, last_box: np.ndarray) -> np.ndarray:
    """IoU of [N,4] dets vs one box (utils/calc_performance.py:54-74)."""
    lt = np.maximum(dets[:, :2], last_box[:2])
    rb = np.minimum(dets[:, 2:], last_box[2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_t = (last_box[2] - last_box[0]) * (last_box[3] - last_box[1])
    return inter / (area_d + area_t - inter)


def _distance_to_last(dets: np.ndarray, last_box: np.ndarray) -> np.ndarray:
    """Center+size pseudo-distance (calculate_distance, calc_performance.py:34-51)."""
    d_hi, d_lo = dets[:, 2:], dets[:, :2]
    t_hi, t_lo = last_box[2:], last_box[:2]
    d_xy = (t_hi + t_lo) / 2 - (d_hi + d_lo) / 2
    d_sz = (d_hi - d_lo) - (t_hi - t_lo)
    d_z = (d_sz[:, 0] + d_sz[:, 1]) / 2
    dis = d_z * d_z + d_xy[:, 0] ** 2 + d_xy[:, 1] ** 2
    return dis ** 0.25


class IoUTracker:
    def __init__(self, cfg: TrackerConfig = TRACKER):
        self.cfg = cfg
        self.active: List[dict] = []
        self.finished: List[dict] = []
        self.frame_num = 0

    def step(self, det_rows: np.ndarray) -> None:
        """Advance one frame.  det_rows: [N,5] rows [x1,y1,x2,y2,score]."""
        cfg = self.cfg
        self.frame_num += 1
        dets = [list(map(float, r)) for r in np.asarray(det_rows)]
        updated = []
        for track in self.active:
            if len(dets) > 0:
                arr = np.array(dets)[:, :4]
                last = np.array(track["bboxes"][-1])
                if cfg.use_iou:
                    scores = _iou_to_last(arr, last)
                    best = int(scores.argmax())
                    matched = scores[best] > cfg.sigma_iou
                else:
                    scores = _distance_to_last(arr, last)
                    best = int(scores.argmin())
                    matched = scores[best] < cfg.sigma_dis
                if matched:
                    track["bboxes"].append(dets[best][:4])
                    track["max_score"] = max(track["max_score"], dets[best][4])
                    updated.append(track)
                    del dets[best]
                elif track["max_score"] > cfg.sigma_h and len(track["bboxes"]) > cfg.t_min:
                    self.finished.append(track)
            # len(dets) == 0: the track is silently dropped (reference behaviour)
        new_tracks = [{"bboxes": [det[:4]], "max_score": det[4],
                       "start_frame": self.frame_num} for det in dets]
        self.active = updated + new_tracks

    def flush(self) -> List[dict]:
        """Final flush (iouTracke_cal.py:174-175)."""
        self.finished += [t for t in self.active
                          if t["max_score"] > self.cfg.sigma_h
                          and len(t["bboxes"]) >= self.cfg.t_min]
        self.active = []
        return self.finished


def track_detections(per_frame_rows: Iterable[np.ndarray],
                     cfg: TrackerConfig = TRACKER) -> List[dict]:
    """Run the tracker over precomputed per-frame detection rows."""
    tracker = IoUTracker(cfg)
    for rows in per_frame_rows:
        tracker.step(rows)
    return tracker.flush()


def save_tracks(tracks: Sequence[dict], path: str) -> None:
    """np.save(video_file + '.npy', ...), the reference's dump format."""
    np.save(path, np.array(tracks))


def load_tracks(path: str) -> List[dict]:
    return list(np.load(path, allow_pickle=True))
