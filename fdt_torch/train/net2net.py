"""Net2net feature distillation (counterpart of fdt/train/net2net.py).

A frozen ResNet50 PyramidBox teacher supervises a mobile student through
MSE on intermediate tensors, the models' `features=True` taps:

  intermedia  Σ w_i · MSE(c_i student, c_i teacher), w = INTERMEDIA_WEIGHTS
  source      Σ SOURCE_WEIGHT · MSE over the 6 SSH source maps
  overall     Σ w · MSE over (face_loc, face_conf, head_loc, head_conf),
              w = OVERALL_WEIGHTS

The teacher runs in eval mode (BatchNorm on its running statistics, as
fdt's teacher.apply(..., train=False)), without gradients; the student in
train mode, SGD as fdt's optax chain (momentum 0.5, weight decay 1e-4).
"""
from __future__ import annotations

import torch

from fdt_torch.infer.pyramidbox import tf32_for
from fdt_torch.train.loops import DeviceTrainer, sgd_optimizer

INTERMEDIA_WEIGHTS = (12.0, 12.0, 12.0, 12.0, 8.0, 8.0)
SOURCE_WEIGHT = 128.0
OVERALL_WEIGHTS = (4.0, 1.0, 4.0, 1.0)
MODES = ("intermedia", "source", "overall")
_OVERALL_KEYS = ("face_loc", "face_conf", "head_loc", "head_conf")


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


class Net2NetTrainer(DeviceTrainer):
    """Distillation trainer: the student learns the teacher's tensors.

    Args:
      student: a PyramidBox variant with its starting weights (the CLI's are
        xavier_init's), trained in place.
      teacher: a PyramidBox with its weights, frozen.
      mode: "intermedia", "source" or "overall".
      precision, device: as DeviceTrainer (device None is the card).
    """

    def __init__(self, student, teacher, mode: str = "intermedia",
                 momentum: float = 0.5, weight_decay: float = 1e-4,
                 input_size: int = 640, precision: str = "default", device=None):
        if mode not in MODES:
            raise ValueError(f"unknown net2net mode {mode!r}; expected one of {MODES}")
        super().__init__(student, precision, torch.float32, device)
        self.mode = mode
        self.input_size = input_size
        self.teacher = teacher.to(self.device).eval().requires_grad_(False)
        self.optimizer = sgd_optimizer(self.model.parameters(), momentum, weight_decay)

    def _loss(self, images):
        x = self._images(images)  # float16 from the prefetcher; float32 here
        heads = self.mode == "overall"
        s_out = self.model(x, heads=heads, features=True)
        with torch.no_grad():
            t_out = self.teacher(x, heads=heads, features=True)
        if self.mode == "intermedia":
            parts = [_mse(a, b) for a, b in zip(s_out["features"], t_out["features"])]
            weights = INTERMEDIA_WEIGHTS
        elif self.mode == "source":
            parts = [_mse(a, b) for a, b in zip(s_out["sources"], t_out["sources"])]
            weights = (SOURCE_WEIGHT,) * len(parts)
        else:
            parts = [_mse(s_out[k], t_out[k]) for k in _OVERALL_KEYS]
            weights = OVERALL_WEIGHTS
        loss = sum(w * p for w, p in zip(weights, parts))
        return loss, torch.stack(parts)

    def train_step(self, images, lr: float) -> dict:
        """One SGD step of the student on NHWC images [B, S, S, 3] (the
        prefetcher's mean-subtracted float16 batch); returns {"loss",
        "parts"} on the device (parts: 6, 6 or 4 by mode)."""
        self.model.train()
        with tf32_for(self.precision):
            loss, parts = self._loss(images)
            loss.backward()
        self._optimizer_step(lr)
        return {"loss": loss.detach(), "parts": parts.detach()}
