"""Typed configuration for the PyramidBox family, FaceBoxes, MTCNN and the
IoU tracker (copy of fdt/config.py:14-175), and for RetinaFace, which the
JAX package does not have.

The port keeps its own copy instead of importing fdt.config, so that nothing
of the JAX package is needed at run time.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """SSD-style prior grid over one or more source maps."""
    strides: Tuple[int, ...]
    boxes: Tuple[int, ...]
    scales: Tuple[int, ...] = ()
    aspect_ratios: Tuple[Tuple[float, ...], ...] = ()

    def __post_init__(self):
        n = len(self.strides)
        if not self.scales:
            object.__setattr__(self, "scales", (1,) * n)
        if not self.aspect_ratios:
            object.__setattr__(self, "aspect_ratios", ((),) * n)


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Test-time decode + per-class NMS parameters."""
    num_classes: int = 2
    background_label: int = 0
    top_k: int = 750           # max detections kept per class
    conf_thresh: float = 0.3
    nms_thresh: float = 0.5
    nms_top_k: int = 5000      # boxes entering NMS
    variance: Tuple[float, float] = (0.1, 0.2)
    # Reference quirk: a class with exactly ONE candidate above conf_thresh
    # is skipped (fdt/config.py:46-49).  Kept by default for bit-faithful
    # output; set False for the fixed behaviour.
    drop_single_candidate: bool = True


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """One PyramidBox family variant."""
    name: str
    input_size: int = 640
    num_sources: int = 6
    face_priors: PriorConfig = dataclasses.field(
        default_factory=lambda: PriorConfig(
            strides=(4, 8, 16, 32, 64, 128), boxes=(16, 32, 64, 128, 256, 512)))
    head_priors: PriorConfig = dataclasses.field(
        default_factory=lambda: PriorConfig(
            strides=(8, 16, 32, 64, 128, 128), boxes=(16, 32, 64, 128, 256, 512)))
    detect: DetectConfig = dataclasses.field(default_factory=DetectConfig)


PYRAMID_REPO = PyramidConfig(
    name="repo",
    detect=DetectConfig(conf_thresh=0.3, nms_thresh=0.5),
)

PYRAMID_TRY1 = PyramidConfig(
    name="try1",
    detect=DetectConfig(conf_thresh=0.3, nms_thresh=0.3),
)

PYRAMID_TRY2 = PyramidConfig(
    name="try2",
    detect=DetectConfig(conf_thresh=0.3, nms_thresh=0.5),
)

_FIVE_MAP_FACE = PriorConfig(strides=(4, 8, 16, 32, 64), boxes=(16, 32, 64, 128, 256))
_FIVE_MAP_HEAD = PriorConfig(strides=(8, 16, 32, 64, 64), boxes=(16, 32, 64, 128, 256))

PYRAMID_TRY3 = PyramidConfig(
    name="try3", num_sources=5,
    face_priors=_FIVE_MAP_FACE, head_priors=_FIVE_MAP_HEAD,
    detect=DetectConfig(conf_thresh=0.2, nms_thresh=0.35),
)
PYRAMID_TRY4 = dataclasses.replace(PYRAMID_TRY3, name="try4")
PYRAMID_TRY5 = dataclasses.replace(PYRAMID_TRY3, name="try5")

PYRAMID_CONFIGS = {c.name: c for c in
                   (PYRAMID_REPO, PYRAMID_TRY1, PYRAMID_TRY2,
                    PYRAMID_TRY3, PYRAMID_TRY4, PYRAMID_TRY5)}

# Mean BGR pixel subtracted before the forward
PIXEL_MEAN_BGR = (104.0, 117.0, 123.0)


@dataclasses.dataclass(frozen=True)
class RetinaConfig:
    """RetinaFace (Deng et al., arXiv:1905.00641) as biubug6/Pytorch_Retinaface
    builds it: `cfg_re50` of its data/config.py for the priors (a source map
    of stride `steps[k]` holds `min_sizes[k]` square priors a cell, no
    clipping) and the settings of its test_widerface.py for the detect
    head (threshold 0.02, top 5000 into NMS at 0.4, 750 kept, and no class
    with a single candidate dropped)."""
    name: str = "Resnet50"
    steps: Tuple[int, ...] = (8, 16, 32)
    min_sizes: Tuple[Tuple[int, ...], ...] = ((16, 32), (64, 128), (256, 512))
    detect: DetectConfig = dataclasses.field(default_factory=lambda: DetectConfig(
        top_k=750, conf_thresh=0.02, nms_thresh=0.4, nms_top_k=5000,
        variance=(0.1, 0.2), drop_single_candidate=False))


RETINA_RES50 = RetinaConfig()


@dataclasses.dataclass(frozen=True)
class FaceBoxConfig:
    """FaceBoxes anchor-densification config."""
    input_size: int = 1024
    steps: Tuple[int, ...] = (32, 64, 128)
    sizes: Tuple[int, ...] = (32, 256, 512)
    aspect_ratios: Tuple[Tuple[int, ...], ...] = ((1, 2, 4), (1,), (1,))
    feature_map_sizes: Tuple[int, ...] = (32, 16, 8)
    density: Tuple[Tuple[int, ...], ...] = ((-3, -1, 1, 3), (-1, 1), (0,))
    variance: Tuple[float, float] = (0.1, 0.2)
    conf_thresh: float = 0.35
    nms_thresh: float = 0.5
    match_thresh: float = 0.35


FACEBOX = FaceBoxConfig()

# The reference's alternative decode_tensor post-processing keeps priors whose
# face probability is strictly above 0.4, then NMS at 0.5 (fdt/config.py:125-136)
FACEBOX_PINNED = FaceBoxConfig(conf_thresh=0.4)


# --- MTCNN (copy of fdt/config.py:139-160) ------------------------------------


@dataclasses.dataclass(frozen=True)
class MTCNNConfig:
    """Cascade thresholds (MTCNN/mtcnn/core/detect.py:73-89)."""
    min_face_size: float = 12.0
    stride: int = 2
    cell_size: int = 12
    thresholds: Tuple[float, float, float] = (0.6, 0.6, 0.35)
    scale_factor: float = 0.709
    pnet_nms_per_level: float = 0.4   # 'Minimum' mode (detect.py:314)
    pnet_nms_merge: float = 0.6       # 'Union'   mode (detect.py:326)
    rnet_nms: float = 0.6             # 'Union'   mode (detect.py:431)
    onet_nms: float = 0.5             # 'Minimum' mode (detect.py:579)
    # fixed-shape budgets of fdt's TPU formulation (padded candidate counts)
    max_pnet_boxes_per_level: int = 2048
    max_pnet_boxes: int = 4096
    max_rnet_boxes: int = 1024
    max_onet_boxes: int = 512


MTCNN = MTCNNConfig()


# --- IoU tracker (copy of fdt/config.py:163-175) ------------------------------


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Greedy IoU tracker thresholds (iouTracke_cal.py:22-30)."""
    use_iou: bool = True
    sigma_iou: float = 0.4
    sigma_dis: float = 8.0
    sigma_h: float = 0.6
    t_min: int = 5
    score_floor: float = 0.4   # detection score floor of the video tracking loop


TRACKER = TrackerConfig()
