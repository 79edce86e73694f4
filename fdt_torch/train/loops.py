"""PyramidBox training: optimizer, xavier init, the train step and the loss
history (counterpart of fdt/train/loops.py).

  * SGD with coupled weight decay and a momentum buffer
    (buf = m·buf + (g + wd·p); p -= lr·buf): optax's
    chain(add_decayed_weights(wd), trace(m)) is torch.optim.SGD(momentum=m,
    weight_decay=wd, dampening=0, nesterov=False); the lr is set on the
    param group every step;
  * the dual MultiBox loss, total = face_l + face_c + 0.5·(head_l + head_c),
    in float32 whatever the forward's compute type;
  * xavier conv init, zero biases, BatchNorm γ = 1, β = 0, mean 0, var 1;
  * the loss history in the reference's 5-row layout.

The trainer owns the model (train mode, on its device), the optimizer and
the step; train-mode BatchNorm stores the biased batch variance as flax does
(fdt_torch.models.common.BatchNorm2d).

Data parallelism (fdt's step sharded over a mesh): while a torch.distributed
process group exists, each rank runs the step on its rows of the global
batch.  BatchNorm's statistics and the loss's positive count are the global
batch's (fdt_torch.models.common, fdt_torch.train.multibox_loss), so each
rank's loss is its part of the one global loss; after the backward the
gradients are summed over the ranks in one flat all-reduce (the frozen
parameters left out on every rank alike), the logged losses too, and
rank 0's parameters and statistics are broadcast before the first step.
The ranks then take the same update and stay equal bit for bit.

On the 2-D data x space mesh (fdt_torch.dist.make_mesh_2d, PyramidTrainer
only) a rank's batch is its data index's rows with the images cut to its
band of rows (fdt_torch.dist.shard_train_batch).  The trainer makes the
model's convs banded (fdt_torch.dist.space.band_convs) and records every
banded op's global input height in its shape pass at the global size; the
forward then runs band by band with halo exchanges over the space group,
and the head outputs are gathered whole, so every rank of a space group
computes its data index's loss.  The loss's counts and the logged metrics
are summed over the data group (each image once); BatchNorm's sums and the
gradient over the world (bands are disjoint, and a rank's gradient is its
band's part of its data index's loss).
"""
from __future__ import annotations

import contextlib
import zlib
from typing import Sequence

import numpy as np
import torch

from fdt_torch.anchors import pyramid_face_priors, pyramid_head_priors
from fdt_torch.config import PYRAMID_CONFIGS, PyramidConfig
from fdt_torch.dist import multihost, space
from fdt_torch.infer.pyramidbox import _check_precision, _resolve_device, tf32_for
from fdt_torch.models.common import checkpoint, running_stats_frozen
from fdt_torch.models.loader import flax_paths
from fdt_torch.train.multibox_loss import MultiBoxLossConfig, multibox_loss

METRICS = ("loss", "face_loc", "face_conf", "head_loc", "head_conf")


def sgd_optimizer(params, momentum: float = 0.6, weight_decay: float = 1e-4):
    """torch.optim.SGD equal to fdt's optax chain; the lr is set each step."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, weight_decay=weight_decay,
                           dampening=0, nesterov=False)


def flax_keystr(path: Sequence[str]) -> str:
    """jax.tree_util.keystr of a flax path: "['params']['conv1']['kernel']"."""
    return "".join(f"['{p}']" for p in path)


def xavier_kernel(path: Sequence[str], shape: Sequence[int], seed: int) -> np.ndarray:
    """Xavier-uniform draw for one conv kernel of flax shape [kH, kW, I, O]:
    U(±√(6/(fan_in+fan_out))), fan_in = I·kH·kW, fan_out = O·kH·kW.  The
    leaf's generator is seeded from `seed` and the crc32 of its flax path,
    never from hash(), which is salted per process.  (fdt draws with
    jax.random from the same digest; the bits differ, the law does not.)"""
    kh, kw, i, o = shape
    bound = np.float32(np.sqrt(6.0 / (i * kh * kw + o * kh * kw)))
    crc = zlib.crc32(flax_keystr(path).encode()) & 0x7FFFFFFF
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed, crc])))
    return rng.uniform(-bound, bound, tuple(shape)).astype(np.float32)


@torch.no_grad()
def xavier_init(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """fdt's init rules in place: conv kernels xavier-uniform (xavier_kernel),
    every bias 0, BatchNorm γ 1 (β is a bias), running mean 0, var 1."""
    paths = flax_paths(model)
    state = model.state_dict()
    for key, path in paths.items():
        t, leaf = state[key], path[-1]
        if leaf == "kernel" and t.dim() == 4:
            w = xavier_kernel(path, (t.shape[2], t.shape[3], t.shape[1], t.shape[0]), seed)
            t.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        elif leaf in ("bias", "mean"):
            t.zero_()
        elif leaf in ("scale", "var"):
            t.fill_(1.0)
    return model


def pad_targets(targets: Sequence[np.ndarray], max_gt: int | None = None):
    """Per-image [n, 5] arrays ([x1, y1, x2, y2, label], normalised) →
    (gt_boxes [B,G,4] f32, gt_labels [B,G] i32, gt_valid [B,G] bool), G the
    smallest power of two ≥ the batch's most GT, or max_gt (fdt's rule)."""
    b = len(targets)
    need = max(1, max(t.shape[0] for t in targets))
    if max_gt is None:
        max_gt = 1 << (need - 1).bit_length()
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, t in enumerate(targets):
        n = min(t.shape[0], max_gt)
        boxes[i, :n] = t[:n, :4]
        labels[i, :n] = t[:n, 4]
        valid[i, :n] = True
    return boxes, labels, valid


def source_shapes(model: torch.nn.Module, input_size: int, device) -> tuple:
    """(f_width, f_height) of every source map, from one eval-mode forward of
    the model at input_size² (exact for try4/try5 too).  While a space group
    exists the pass runs whole, with the head-supervision branch, and
    records every banded op's global input height
    (fdt_torch.dist.space.recording)."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            x = torch.zeros(1, 3, input_size, input_size, device=device)
            if multihost.space_group() is None:
                return model(x)["source_shapes"]
            with space.recording():
                return model(x, heads=True)["source_shapes"]
    finally:
        model.train(was_training)


class DeviceTrainer:
    """What the port's trainers share: the model in train mode on one
    device, the precision and compute type of its forward, the upload of a
    batch, and the optimizer step with fdt's conventions.

    Args:
      model: moved to `device` (channels_last for bf16) and put in train mode.
      precision: "default" (TF32 allowed, fdt's default) or "highest".
      dtype: torch.float32, or torch.bfloat16: the forward and backward under
        autocast, float32 parameters, optimizer state and loss.
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
    A subclass sets `self.optimizer`, and `data_parallel = True` when its
    step has fdt's data-parallel form (train_step calls _group() first and
    _sum_gradients() after the backward), `space_parallel = True` when it
    also runs on the 2-D data x space mesh.
    """

    data_parallel = False
    space_parallel = False

    def __init__(self, model, precision: str = "default",
                 dtype: torch.dtype = torch.float32, device=None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.precision = _check_precision(precision)
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.memory_format = (torch.channels_last if dtype == torch.bfloat16
                              else torch.contiguous_format)
        self.model = model.to(self.device, memory_format=self.memory_format).train()
        self.step = 0
        self._replicas_synced = False

    def _group(self):
        """The process group while one exists (None otherwise); before this
        trainer's first step under it, rank 0's parameters and buffers are
        broadcast to every rank."""
        group = multihost.group()
        if group is not None:
            self._check_data_parallel()
            if not self._replicas_synced:
                multihost.broadcast_module(self.model)
                self._replicas_synced = True
        return group

    def _check_data_parallel(self) -> None:
        if multihost.group() is not None and not self.data_parallel:
            raise NotImplementedError(f"{type(self).__name__} has no data-parallel step "
                                      "(fdt's has none either)")
        if multihost.space_group() is not None and not self.space_parallel:
            raise NotImplementedError(f"{type(self).__name__} has no step on the data x "
                                      "space mesh (fdt's trains PyramidBox alone on it)")

    @torch.no_grad()
    def _sum_gradients(self, skip=None) -> None:
        """Σ over the ranks of every gradient, in one flat all-reduce; the
        parameters that `skip(name)` names (frozen ones) and those without a
        gradient are left out, on every rank alike."""
        grads = [p.grad for name, p in self.model.named_parameters()
                 if p.grad is not None and not (skip is not None and skip(name))]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    @staticmethod
    def _metrics(names, *values) -> dict:
        """The step's metrics as 0-d tensors; under a process group each is
        summed over the data group (the world on the 1-D mesh: the parts of
        one global loss), so every rank logs the global values."""
        values = [v.detach() for v in values]
        if multihost.group() is not None:
            values = list(multihost.sum_over_ranks(torch.stack(values),
                                                   group=multihost.data_group()))
        return dict(zip(names, values))

    def _put(self, x, dtype=None) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return x.to(self.device, non_blocking=True).to(dtype or x.dtype)

    def _images(self, images, scale: float | None = None) -> torch.Tensor:
        """NHWC images (float16 from the prefetcher, float32 or uint8) → the
        model's NCHW float32 input on the device, divided by `scale` first
        when given (fdt's arithmetic: the cast, then the division)."""
        x = self._put(images, torch.float32)
        if scale is not None:
            x = x / scale
        return x.permute(0, 3, 1, 2).contiguous(memory_format=self.memory_format)

    def _autocast(self):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def _optimizer_step(self, lr: float | None = None, zero_grad=None) -> None:
        """The update after a backward: a parameter without a gradient gets
        zeros (fdt's gradient of an unused leaf; weight decay and momentum
        still move it), `zero_grad(name)` zeroes a frozen one's, `lr` (when
        given) is set on every group, then one optimizer step."""
        self._check_data_parallel()
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif zero_grad is not None and zero_grad(name):
                p.grad.zero_()
        if lr is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = float(lr)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


class PyramidTrainer(DeviceTrainer):
    """The train step of a PyramidBox variant on one device, or on one rank
    of a data-parallel group (see the module's docstring).

    Args:
      model: the variant's model (fdt_torch.models.build_pyramidbox; with
        remat=True the flagship checkpoints every block), moved to `device`
        and put in train mode.
      cfg: a PyramidConfig or its name: the priors.
      precision: "default" (TF32 allowed, fdt's default) or "highest".
      freeze_predicate: over parameter names; with freeze=True their
        gradients are zeroed (weight decay and momentum still move them).
      remat: checkpoint the whole forward (fdt's mobile --remat).
      dtype: torch.float32, or torch.bfloat16: the forward and backward under
        autocast, float32 parameters, optimizer state and loss.
      device: None → "cuda" (raises if absent); "cpu" for the CPU.
    """

    data_parallel = True
    space_parallel = True

    def __init__(self, model, cfg: PyramidConfig | str = "repo", input_size: int = 640,
                 loss_cfg: MultiBoxLossConfig = MultiBoxLossConfig(),
                 head_weight: float = 0.5, momentum: float = 0.6,
                 weight_decay: float = 1e-4, precision: str = "default",
                 freeze_predicate=None, remat: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(model, precision, dtype, device)
        self.cfg = PYRAMID_CONFIGS[cfg] if isinstance(cfg, str) else cfg
        self.loss_cfg = loss_cfg
        self.head_weight = head_weight
        self.freeze_predicate = freeze_predicate
        self.remat = remat
        self.optimizer = sgd_optimizer(self.model.parameters(), momentum, weight_decay)
        self.input_size = input_size
        if multihost.space_group() is not None:
            space.band_convs(self.model)
        shapes = source_shapes(self.model, input_size, self.device)
        self.priors_face = torch.from_numpy(
            pyramid_face_priors(self.cfg, shapes, input_size, input_size)).to(self.device)
        self.priors_head = torch.from_numpy(
            pyramid_head_priors(self.cfg, shapes, input_size, input_size)).to(self.device)

    def _losses(self, images, gt_boxes, gt_labels, gt_valid):
        """(total loss, (face_l, face_c, head_l, head_c)); images [B,S,S,3]
        NHWC (float16 from the prefetcher, or float32), cast to float32 on
        the device."""
        x = self._images(images)
        gt_boxes = self._put(gt_boxes, torch.float32)
        gt_labels, gt_valid = self._put(gt_labels), self._put(gt_valid)
        with self._autocast():
            fwd = lambda x: self.model(x, heads=True)  # noqa: E731
            out = checkpoint(fwd, x) if self.remat and torch.is_grad_enabled() else fwd(x)
        # the loss math (matching, mining, log-sum-exp) must run in float32
        check_float32(out, ("face_loc", "face_conf", "head_loc", "head_conf"))
        l_l, l_c = multibox_loss(out["face_loc"], out["face_conf"], self.priors_face,
                                 gt_boxes, gt_labels, gt_valid, self.loss_cfg)
        h_l, h_c = multibox_loss(out["head_loc"], out["head_conf"], self.priors_head,
                                 gt_boxes, gt_labels, gt_valid, self.loss_cfg)
        return l_l + l_c + self.head_weight * (h_l + h_c), (l_l, l_c, h_l, h_c)

    def train_step(self, images, gt_boxes, gt_labels, gt_valid, lr: float,
                   freeze: bool = False) -> dict:
        """One SGD step; returns the metrics as 0-d tensors on the device
        (no host synchronisation).  Under a process group the batch is this
        rank's rows of the global batch (on the 2-D mesh, with the images
        cut to the rank's band) and the metrics are global."""
        group = self._group()
        self.model.train()
        with tf32_for(self.precision):
            loss, parts = self._losses(images, gt_boxes, gt_labels, gt_valid)
            loss.backward()
        frozen = self.freeze_predicate if freeze else None
        if group is not None:
            self._sum_gradients(frozen)
        self._optimizer_step(lr, frozen)
        return self._metrics(METRICS, loss, *parts)

    def eval_loss(self, images, gt_boxes, gt_labels, gt_valid) -> torch.Tensor:
        """Validation loss as fdt computes it: a train-mode forward
        (BatchNorm on batch statistics) whose statistics are dropped, so the
        running statistics, the parameters and the step stay as they were.
        Under a process group: the global batch's loss, on every rank."""
        self._group()
        self.model.train()
        with torch.no_grad(), running_stats_frozen(), tf32_for(self.precision):
            return multihost.sum_over_ranks(
                self._losses(images, gt_boxes, gt_labels, gt_valid)[0],
                group=multihost.data_group())


def check_float32(out: dict, keys) -> None:
    """The loss math must run in float32, whatever the forward's type."""
    for k in keys:
        if out[k].dtype != torch.float32:
            raise TypeError(f"model output {k!r} is {out[k].dtype}, "
                            "expected float32 (loss math must be f32)")


class LossHistory:
    """5-row loss array (total / face_loc / face_conf / head_loc / head_conf)
    in the reference's dump layout.  append() keeps the metrics on the
    device; they reach the host in one copy at drain() / save()."""

    def __init__(self, save_point: int):
        self.save_point = save_point
        self.pending: list = []
        self.buf = np.zeros((5, save_point + 1))
        self.idx = 0

    def reset(self) -> None:
        """Drop the history kept since the last save (a rank that does not
        write the loss files, as fdt's other processes)."""
        self.pending = []
        self.buf = np.zeros_like(self.buf)
        self.idx = 0

    def append(self, metrics: dict) -> None:
        self.pending.append(torch.stack([metrics[k].float() for k in METRICS]))

    def drain(self) -> None:
        if self.pending:
            vals = torch.stack(self.pending).cpu().double().numpy()
            if len(vals) > self.buf.shape[1] - self.idx:
                raise IndexError(
                    f"{self.idx + len(vals)} loss rows exceed the "
                    f"save_point={self.buf.shape[1] - 1} buffer; save() "
                    f"must run at least once per save_point iterations")
            self.buf[:, self.idx:self.idx + len(vals)] = vals.T
            self.idx += len(vals)
            self.pending = []

    def save(self, path: str) -> None:
        self.drain()
        np.save(path, self.buf)
        self.reset()
