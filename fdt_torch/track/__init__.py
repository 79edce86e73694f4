from fdt_torch.track.device_tracker import DeviceIoUTracker
from fdt_torch.track.fused import FusedVideoTracker
from fdt_torch.track.iou_tracker import IoUTracker, load_tracks, save_tracks, track_detections

__all__ = ["IoUTracker", "DeviceIoUTracker", "FusedVideoTracker", "track_detections",
           "save_tracks", "load_tracks"]
