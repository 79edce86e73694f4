from fdt_torch.infer.detect import ssd_detect
from fdt_torch.infer.pyramidbox import PyramidBoxDetector, detections_to_rows

__all__ = ["ssd_detect", "PyramidBoxDetector", "detections_to_rows"]
