"""End-to-end PyramidBox training driver (counterpart of fdt/train/driver.py).

Epoch-shuffled augmented batches built on a worker thread, step-decayed SGD,
loss-history dumps in the reference's 5-row layout, eval over validation
batches, step-suffixed checkpoints (fdt_torch.train.checkpoint) and the
backbone-freeze window.  One device; data parallelism (fdt's `mesh=`) is
ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from fdt_torch.data.widerface import WiderFaceDataset
from fdt_torch.train.checkpoint import save_checkpoint
from fdt_torch.train.loops import LossHistory, PyramidTrainer, pad_targets


@dataclasses.dataclass
class TrainConfig:
    """The reference trainer's argparse defaults (fdt's TrainConfig)."""
    batch_size: int = 7
    lr: float = 2e-5
    total_iters: int = 120_000
    save_point: int = 3000
    step_values: Sequence[int] = (120_000, 300_000, 100_000)
    gamma: float = 0.5
    eval_freq: int = 0           # 0 disables (the mobile trainer uses 500)
    eval_batches: int = 50
    train_pretrain: int = 0      # freeze the backbone before this iteration
    max_gt: int | None = None    # GT pad bucket override
    start_iter: int = 0
    name: str = "Res50_pyramid"
    save_folder: str = "weights_of_mine/"
    stall_timeout: float = 0.0   # >0: hard-exit STALL_EXIT_CODE when a step
                                 # wedges this long (fdt_torch.utils.watchdog);
                                 # the first step is exempt
    startup_timeout: float = 0.0  # >0: the same, before the first synced step


# seconds close() waits for the prefetch worker to finish the batch it builds
JOIN_TIMEOUT_S = 60.0


def prefetch_batches(dataset, batch_size: int, depth: int = 3, pin: bool = False,
                     stats: dict | None = None):
    """Endless epoch-shuffled batches, built on a background thread.

    Each batch's images are cast to float16, as fdt's prefetcher sends them
    (the trainer casts them back to float32 on the device: fdt's arithmetic,
    whose parity tests feed both sides the same rounded batch), as a torch
    tensor, in pinned memory when `pin` so that the copy to the card is
    asynchronous.  `depth` bounds the queue.  A worker exception re-raises
    in the consumer; closing the generator stops the worker and waits for
    it (a daemon thread still inside torch when the interpreter exits can
    abort the process: "terminate called without an active exception").
    `stats`, if given, gets "augment_s" (the worker's seconds building
    batches) and "augmented" (images built)."""
    import queue
    import threading

    if len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} records < batch_size "
                         f"{batch_size}; no full batch can be built")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    if stats is not None:
        stats.update(augment_s=0.0, augmented=0)

    def worker():
        try:
            while not stop.is_set():
                t = time.perf_counter()
                for images, targets in dataset.batches(batch_size):
                    images = torch.from_numpy(images.astype(np.float16))
                    if pin:
                        images = images.pin_memory()
                    if stats is not None:
                        stats["augment_s"] += time.perf_counter() - t
                        stats["augmented"] += len(targets)
                    item = (images, targets)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                    t = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.2)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=JOIN_TIMEOUT_S)


def run_pyramid_training(trainer: PyramidTrainer, train_anno: str, cfg: TrainConfig,
                         val_anno: str | None = None,
                         log: Callable[[str], None] = print, mesh=None,
                         stats: dict | None = None) -> PyramidTrainer:
    """Train from cfg.start_iter + 1 to cfg.total_iters; checkpoints and loss
    .npy files at the save points and a final checkpoint.  Returns the
    trainer.  `stats`, if given, gets the loop's wall seconds ("wall_s"), the
    seconds it waited on the prefetch queue ("wait_s"), the iterations run
    and the worker's augmentation figures (prefetch_batches)."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training (mesh=) is not ported yet: "
                                  "ROADMAP Queue 1 item 5 (distribution)")
    dataset = WiderFaceDataset(train_anno, size=trainer.input_size)
    val_dataset = (WiderFaceDataset(val_anno, size=trainer.input_size)
                   if val_anno else None)
    stats = {} if stats is None else stats
    batches = prefetch_batches(dataset, cfg.batch_size, pin=trainer.device.type == "cuda",
                               stats=stats)
    try:
        return _training_loop(trainer, batches, cfg, val_dataset, log, stats)
    finally:
        batches.close()  # stop the prefetch worker


def _training_loop(trainer, batches, cfg, val_dataset, log, stats):
    from fdt_torch.utils.watchdog import StallWatchdog
    with StallWatchdog(cfg.stall_timeout, name=cfg.name,
                       startup_limit_s=cfg.startup_timeout) as watchdog:
        return _training_loop_inner(trainer, batches, cfg, val_dataset, log, stats,
                                    watchdog)


def _training_loop_inner(trainer, batches, cfg, val_dataset, log, stats, watchdog):
    history = LossHistory(cfg.save_point)
    eval_losses: list[float] = []
    step_index = 0
    lr = cfg.lr
    stats.update(wait_s=0.0, iterations=0)
    t_loop = time.perf_counter()
    for iteration in range(cfg.start_iter + 1, cfg.total_iters + 1):
        t0 = time.time()
        t_wait = time.perf_counter()
        images, targets = next(batches)
        stats["wait_s"] += time.perf_counter() - t_wait
        if iteration in cfg.step_values:
            step_index += 1
            lr = cfg.lr * (cfg.gamma ** step_index)
            log(f"adjusting lr to {lr}")

        gt_boxes, gt_labels, gt_valid = pad_targets(targets, cfg.max_gt)
        metrics = trainer.train_step(images, gt_boxes, gt_labels, gt_valid, lr,
                                     freeze=iteration < cfg.train_pretrain)
        history.append(metrics)
        stats["iterations"] += 1

        if iteration % 20 == 0:
            # the float() reads are the loop's only per-step host syncs: a
            # beat here means the last ~20 steps landed
            log(f"iter {iteration} || loss {float(metrics['loss']):.4f} || "
                f"loc {float(metrics['face_loc']):.4f} conf {float(metrics['face_conf']):.4f} || "
                f"lr {lr} || {time.time() - t0:.2f}s")
            watchdog.beat()

        if cfg.eval_freq and (iteration % cfg.eval_freq == 0 or iteration == 1) \
                and val_dataset is not None:
            loss_val, n = 0.0, 0
            for img_e, tgt_e in val_dataset.batches(cfg.batch_size):
                n += 1
                gb, gl, gv = pad_targets(tgt_e, cfg.max_gt)
                loss_val += float(trainer.eval_loss(img_e, gb, gl, gv))
                watchdog.beat()
                if n > cfg.eval_batches:
                    break
            eval_losses.append(loss_val / max(n, 1))
            log(f"eval loss = {eval_losses[-1]:.5f}")

        if iteration % cfg.save_point == 0:
            path = save_checkpoint(trainer, cfg.save_folder, cfg.name, iteration)
            history.save(f"{cfg.save_folder}/{cfg.name}_loss_{iteration}.npy")
            if eval_losses:
                np.save(f"{cfg.save_folder}/{cfg.name}_eval_loss_{iteration}.npy",
                        np.array(eval_losses))
                eval_losses = []
            log(f"saved {path}")

    save_checkpoint(trainer, cfg.save_folder, cfg.name, cfg.total_iters)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    stats["wall_s"] = time.perf_counter() - t_loop
    return trainer
