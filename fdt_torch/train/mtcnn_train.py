"""MTCNN stage training: masked losses and the Adam trainer (counterpart of
fdt/train/mtcnn_train.py).

Loss masks by label (1 positive, 0 negative, -1 part, -2 landmark):
  cls (BCE):       labels >= 0
  box (MSE):       labels != 0 (positive, part, landmark)
  landmark (MSE):  labels == -2
each a masked mean over max(Σ mask, 1).  Stage weights: PNet and RNet
cls·1.0 + box·0.5; ONet cls·0.8 + box·0.6 + landmark·1.5.

Adam is optax.adam's update: torch.optim.Adam(betas=(0.9, 0.999),
eps=1e-8) divides the bias-corrected first moment by the square root of
the bias-corrected second moment plus eps (eps outside the root, no eps
inside it), which is optax's scale_by_adam with eps_root 0.
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from fdt_torch.infer.pyramidbox import tf32_for
from fdt_torch.models.loader import flax_paths
from fdt_torch.models.mtcnn import ONet, PNet, RNet
from fdt_torch.train.loops import DeviceTrainer, flax_keystr

STAGE_WEIGHTS = {  # cls, box, landmark
    "pnet": (1.0, 0.5, 0.0),
    "rnet": (1.0, 0.5, 0.0),
    "onet": (0.8, 0.6, 1.5),
}
STAGE_SIZES = {"pnet": 12, "rnet": 24, "onet": 48}
STAGE_MODELS = {"pnet": PNet, "rnet": RNet, "onet": ONet}
METRICS = ("loss", "cls", "box", "landmark", "accuracy")


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cls_loss(gt_label: torch.Tensor, pred_prob: torch.Tensor, eps: float = 1e-7):
    """Masked BCE over labels >= 0 of sigmoid outputs, clipped to [eps, 1-eps]."""
    p = torch.clamp(pred_prob.reshape(-1), eps, 1 - eps)
    gt = gt_label.reshape(-1)
    mask = (gt >= 0).to(p.dtype)
    target = torch.clamp(gt, 0.0, 1.0)
    bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return _masked_mean(bce, mask)


def box_loss(gt_label: torch.Tensor, gt_offset: torch.Tensor, pred_offset: torch.Tensor):
    """Masked MSE over labels != 0, each row's mean over its 4 offsets."""
    mask = (gt_label.reshape(-1) != 0).to(pred_offset.dtype)
    se = torch.mean((pred_offset - gt_offset) ** 2, dim=-1)
    return _masked_mean(se, mask)


def landmark_loss(gt_label: torch.Tensor, gt_landmark: torch.Tensor,
                  pred_landmark: torch.Tensor):
    """Masked MSE over labels == -2, each row's mean over its 10 values."""
    mask = (gt_label.reshape(-1) == -2).to(pred_landmark.dtype)
    se = torch.mean((pred_landmark - gt_landmark) ** 2, dim=-1)
    return _masked_mean(se, mask)


def compute_accuracy(pred_prob: torch.Tensor, gt_label: torch.Tensor, thresh: float = 0.6):
    """The share of labels >= 0 that prob >= thresh gets right."""
    p = pred_prob.reshape(-1)
    gt = gt_label.reshape(-1)
    mask = (gt >= 0).to(p.dtype)
    ones = (p >= thresh).to(p.dtype)
    right = (ones == gt).to(p.dtype) * mask
    return torch.sum(right) / torch.clamp(torch.sum(mask), min=1.0)


@torch.no_grad()
def lecun_init(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """flax's default init in place, as fdt's Module.init gives an MTCNN net:
    conv and Dense kernels lecun-normal (a normal truncated to ±2 standard
    deviations, scaled to variance 1/fan_in), biases 0, PReLU slopes 0.01.
    Each leaf's generator is seeded from `seed` and the crc32 of its flax
    path (fdt draws with jax.random: the law is the same, the bits are not)."""
    params = dict(model.named_parameters())
    for key, path in flax_paths(model).items():
        t, leaf = params[key], path[-1]
        if leaf == "kernel":
            fan_in = t[0].numel()
            crc = zlib.crc32(flax_keystr(path).encode()) & 0x7FFFFFFF
            rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed, crc])))
            draw = rng.standard_normal(t.numel() * 2)
            draw = draw[np.abs(draw) <= 2][:t.numel()]
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            t.copy_(torch.from_numpy((draw * std).astype(np.float32)).reshape(t.shape))
        elif leaf == "bias":
            t.zero_()
        elif leaf == "negative_slope":
            t.fill_(0.01)
    return model


class MTCNNStageTrainer(DeviceTrainer):
    """One cascade stage with Adam (base_lr 0.01, the reference's).

    Args:
      stage: "pnet", "rnet" or "onet".
      model: the stage's net with its starting weights; by default a fresh
        one under lecun_init(seed).
      precision, device: as DeviceTrainer (device None is the card).
    """

    def __init__(self, stage: str, base_lr: float = 0.01, precision: str = "default",
                 model: torch.nn.Module | None = None, seed: int = 0, device=None):
        if stage not in STAGE_MODELS:
            raise ValueError(f"unknown MTCNN stage {stage!r}; expected one of "
                             f"{tuple(STAGE_MODELS)}")
        model = model if model is not None else lecun_init(STAGE_MODELS[stage](), seed)
        super().__init__(model, precision, torch.float32, device)
        self.stage = stage
        self.size = STAGE_SIZES[stage]
        self.weights = STAGE_WEIGHTS[stage]
        self.base_lr = base_lr
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=base_lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def _loss(self, images, gt_label, gt_bbox, gt_landmark):
        out = self.model(self._images(images, 255.0))
        if self.stage == "pnet":  # the FCN on a 12² input: [B, ·, 1, 1] maps
            prob, box = out[0][:, :, 0, 0], out[1][:, :, 0, 0]
            lm = None
        elif self.stage == "rnet":
            (prob, box), lm = out, None
        else:
            prob, box, lm = out
        gt_label = self._put(gt_label, torch.float32)
        wc, wb, wl = self.weights
        l_cls = cls_loss(gt_label, prob)
        l_box = box_loss(gt_label, self._put(gt_bbox, torch.float32), box)
        loss = wc * l_cls + wb * l_box
        l_lm = torch.zeros((), device=self.device)
        if lm is not None:
            l_lm = landmark_loss(gt_label, self._put(gt_landmark, torch.float32), lm)
            loss = loss + wl * l_lm
        return loss, (l_cls, l_box, l_lm, compute_accuracy(prob.detach(), gt_label))

    def train_step(self, images, gt_label, gt_bbox, gt_landmark) -> dict:
        """One Adam step on NHWC uint8 BGR patches [B, S, S, 3] and their
        labels [B], box offsets [B, 4] and landmarks [B, 10]; returns
        {"loss", "cls", "box", "landmark", "accuracy"} on the device."""
        self.model.train()
        with tf32_for(self.precision):
            loss, parts = self._loss(images, gt_label, gt_bbox, gt_landmark)
            loss.backward()
        self._optimizer_step()
        return dict(zip(METRICS, (t.detach() for t in (loss, *parts))))


def train_stage(stage: str, imdb, end_epoch: int, batch_size: int, model_store_path: str,
                base_lr: float = 0.01, frequent: int = 50, rng_seed: int = 0, log=print,
                device=None) -> MTCNNStageTrainer:
    """The epoch loop: shuffled batches (mtcnn_batches, a RandomState of
    `rng_seed`), a log line every `frequent` steps and a checkpoint
    `<model_store_path>/<stage>_epoch_<epoch>` after every epoch.  Returns
    the trainer."""
    from fdt_torch.data.mtcnn_data import mtcnn_batches
    from fdt_torch.train.checkpoint import save_checkpoint

    os.makedirs(model_store_path, exist_ok=True)
    trainer = MTCNNStageTrainer(stage, base_lr, seed=rng_seed, device=device)
    rng = np.random.RandomState(rng_seed)
    for epoch in range(1, end_epoch + 1):
        for i, (ims, label, bbox, lm) in enumerate(
                mtcnn_batches(imdb, batch_size, shuffle=True, rng=rng)):
            m = trainer.train_step(ims, label, bbox, lm)
            if i % frequent == 0:
                log(f"{stage} epoch {epoch} step {i} acc {float(m['accuracy']):.3f} "
                    f"cls {float(m['cls']):.4f} box {float(m['box']):.4f} "
                    f"loss {float(m['loss']):.4f}")
        save_checkpoint(trainer, model_store_path, f"{stage}_epoch", epoch)
    return trainer
