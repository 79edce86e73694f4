from fdt_torch.track.device_tracker import DeviceIoUTracker
from fdt_torch.track.fused import FusedVideoTracker, track_video_fused
from fdt_torch.track.iou_tracker import (IoUTracker, load_tracks, save_tracks, track_detections,
                                         track_video)

__all__ = ["IoUTracker", "DeviceIoUTracker", "FusedVideoTracker", "track_detections",
           "track_video", "track_video_fused", "save_tracks", "load_tracks"]
