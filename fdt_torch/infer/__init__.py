from fdt_torch.infer.detect import ssd_detect
from fdt_torch.infer.facebox import FaceBoxDetector
from fdt_torch.infer.mtcnn import MTCNNDetector, load_mtcnn_detector
from fdt_torch.infer.mtcnn_device import (FAST_BUDGETS, MID_BUDGETS, DeviceBudgets,
                                          MTCNNDeviceCascade)
from fdt_torch.infer.pyramidbox import PyramidBoxDetector, detections_to_rows
from fdt_torch.infer.retinaface import RetinaFaceDetector, landmark_rows_of

__all__ = ["ssd_detect", "PyramidBoxDetector", "FaceBoxDetector", "detections_to_rows",
           "MTCNNDetector", "load_mtcnn_detector", "MTCNNDeviceCascade", "DeviceBudgets",
           "FAST_BUDGETS", "MID_BUDGETS", "RetinaFaceDetector", "landmark_rows_of"]
