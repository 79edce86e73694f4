"""FaceBoxes trainer (counterpart of fdt/train/facebox_train.py).

Targets from the densified-anchor encoder (fdt_torch.anchors.densified.
facebox_encode), the SSD MultiBox loss with 3:1 hard-negative mining
(multibox_loss_from_targets) and SGD with momentum 0.9 and weight decay
5e-4, fdt's FaceBoxes recipe.  The input protocol is the family's: raw BGR
pixels divided by 255 (PyramidBox's is mean subtraction).
"""
from __future__ import annotations

import torch

from fdt_torch.anchors.densified import facebox_default_boxes, facebox_encode
from fdt_torch.config import FACEBOX, FaceBoxConfig
from fdt_torch.infer.pyramidbox import tf32_for
from fdt_torch.models.facebox import FaceBox
from fdt_torch.train.loops import DeviceTrainer, check_float32, sgd_optimizer
from fdt_torch.train.multibox_loss import multibox_loss_from_targets

METRICS = ("loss", "loc", "conf")


class FaceBoxTrainer(DeviceTrainer):
    """The FaceBoxes train step on one device.

    Args:
      model: a FaceBox with its starting weights (the CLI's are xavier_init's),
        moved to `device`.
      cfg: the FaceBoxConfig of the default boxes and the match threshold.
      precision, dtype, device: as DeviceTrainer (device None is the card).
    """

    def __init__(self, model: FaceBox, cfg: FaceBoxConfig = FACEBOX, negpos_ratio: int = 3,
                 momentum: float = 0.9, weight_decay: float = 5e-4, precision: str = "default",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(model, precision, dtype, device)
        self.cfg = cfg
        self.negpos_ratio = negpos_ratio
        self.input_size = cfg.input_size
        self.defaults = torch.tensor(facebox_default_boxes(cfg), device=self.device)
        self.optimizer = sgd_optimizer(self.model.parameters(), momentum, weight_decay)

    def _losses(self, images, gt_boxes, gt_labels, gt_valid):
        x = self._images(images, 255.0)  # the family's /255 protocol
        with self._autocast():
            loc, conf = self.model(x)
        check_float32({"loc": loc, "conf": conf}, ("loc", "conf"))
        with torch.no_grad():
            loc_t, conf_t = facebox_encode(self._put(gt_boxes, torch.float32),
                                           self._put(gt_labels), self._put(gt_valid),
                                           self.defaults, self.cfg.match_thresh)
        l_l, l_c = multibox_loss_from_targets(loc, conf, loc_t, conf_t, self.negpos_ratio)
        return l_l + l_c, (l_l, l_c)

    def train_step(self, images, gt_boxes, gt_labels, gt_valid, lr: float) -> dict:
        """One SGD step on NHWC BGR images [B, S, S, 3] (0-255) and padded GT
        (fdt_torch.train.pad_targets; labels 1 for faces); returns {"loss",
        "loc", "conf"} as 0-d tensors on the device."""
        self.model.train()
        with tf32_for(self.precision):
            loss, parts = self._losses(images, gt_boxes, gt_labels, gt_valid)
            loss.backward()
        self._optimizer_step(lr)
        return dict(zip(METRICS, (t.detach() for t in (loss, *parts))))
