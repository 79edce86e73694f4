"""End-to-end PyramidBox training driver (counterpart of fdt/train/driver.py).

Epoch-shuffled augmented batches built on a worker thread, step-decayed SGD,
loss-history dumps in the reference's 5-row layout, eval over validation
batches, step-suffixed checkpoints (fdt_torch.train.checkpoint) and the
backbone-freeze window.  On one device, or data-parallel (fdt's `mesh=`):
one rank a device in a torch.distributed process group, each rank's mesh
holding its one device (fdt_torch.dist; started by
`python -m fdt_torch.cli.train_pyramid --dp_devices n | --num_processes n`),
or on the 2-D data × space mesh (`--dp_devices d --sp_devices s`: a rank
its data index's rows and its band of each image's rows).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from fdt_torch.data.widerface import WiderFaceDataset
from fdt_torch.dist import multihost, space
from fdt_torch.dist.mesh import Mesh2D, canonical_device
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


def check_training_mesh(mesh, trainer) -> None:
    """A training mesh holds the one device its rank drives, the trainer's
    (on the 2-D mesh, the rank's device of the mesh's one a rank).  fdt's
    single-process mesh over several devices has no counterpart: the port
    trains one process a device."""
    if isinstance(mesh, Mesh2D):
        if mesh.device != canonical_device(trainer.device):
            raise ValueError(f"rank {mesh.rank}'s device {mesh.device} is not the "
                             f"trainer's {trainer.device}")
        return
    if mesh.size != 1:
        raise ValueError(
            f"a training mesh holds its rank's one device, not {mesh.size}: the port "
            "trains data-parallel with one process a device; start them with "
            "python -m fdt_torch.cli.train_pyramid --dp_devices n (n local ranks) or "
            "--num_processes n (a process each)")
    if mesh.devices[0] != canonical_device(trainer.device):
        raise ValueError(f"the mesh's device {mesh.devices[0]} is not the trainer's "
                         f"{trainer.device}")


def run_pyramid_training(trainer: PyramidTrainer, train_anno: str, cfg: TrainConfig,
                         val_anno: str | None = None,
                         log: Callable[[str], None] = print, mesh=None,
                         stats: dict | None = None, shard: str = "records") -> PyramidTrainer:
    """Train from cfg.start_iter + 1 to cfg.total_iters; checkpoints and loss
    .npy files at the save points and a final checkpoint.  Returns the
    trainer.  `stats`, if given, gets the loop's wall seconds ("wall_s"), the
    seconds it waited on the prefetch queue ("wait_s"), the iterations run
    and the worker's augmentation figures (prefetch_batches).

    mesh: this rank's fdt_torch.dist.Mesh (check_training_mesh) for
    data-parallel training under a process group of more than one rank;
    `shard` says how the ranks split the data:
      "records" — fdt's multi-process contract: rank i takes the record
        shard records[i::n] with RandomState(1 + i) and cfg.batch_size rows
        a step, so the global batch is n × batch_size; cfg.max_gt is
        required (the ranks' GT pads must agree);
      "rows" — fdt's one-process mesh, replayed by n ranks: every rank runs
        the same seeded pipeline and keeps its rows [r·B/n, (r+1)·B/n) of
        each batch of B = cfg.batch_size rows, so the batches are fdt's;
      "space" — fdt's 2-D data × space mesh (a Mesh2D): as "rows" over the
        data axis (its data index's rows), and of the images the rank's band
        of rows (space.band over the input size), fdt's P("data", "space").
    The validation batches are not sharded by records (every rank walks the
    same ones; "rows" and "space" keep a rank's part).  Rank 0 writes the
    checkpoints and the loss files; the others reset their history and wait
    for it."""
    rows = band = None
    if mesh is not None:
        check_training_mesh(mesh, trainer)
    dataset = WiderFaceDataset(train_anno, size=trainer.input_size)
    val_dataset = (WiderFaceDataset(val_anno, size=trainer.input_size)
                   if val_anno else None)
    if mesh is not None and mesh.world_size > 1:
        i, n = mesh.rank, mesh.world_size
        if shard == "records":
            if cfg.max_gt is None:
                raise ValueError("multi-process training requires cfg.max_gt: the ranks' "
                                 "GT pads must agree")
            dataset.records = dataset.records[i::n]
            dataset.rng = np.random.RandomState(1 + i)
        elif shard == "rows":
            rows = slice(*multihost.process_batch_bounds(cfg.batch_size, i, n))
        elif shard == "space":
            if not isinstance(mesh, Mesh2D):
                raise ValueError("shard='space' takes the 2-D mesh (make_mesh_2d)")
            rows = slice(*multihost.process_batch_bounds(cfg.batch_size, mesh.data_index,
                                                         mesh.n_data))
            band = slice(*space.band(trainer.input_size, mesh.n_space, mesh.space_index))
        else:
            raise ValueError(f"shard must be 'records', 'rows' or 'space', got {shard!r}")
    if isinstance(mesh, Mesh2D) and shard != "space":
        raise ValueError(f"the 2-D mesh takes shard='space', not {shard!r}")
    stats = {} if stats is None else stats
    batches = prefetch_batches(dataset, cfg.batch_size, pin=trainer.device.type == "cuda",
                               stats=stats)
    try:
        return _training_loop(trainer, batches, cfg, val_dataset, log, stats, (rows, band))
    finally:
        batches.close()  # stop the prefetch worker


def _training_loop(trainer, batches, cfg, val_dataset, log, stats, part):
    from fdt_torch.utils.watchdog import StallWatchdog
    with StallWatchdog(cfg.stall_timeout, name=cfg.name,
                       startup_limit_s=cfg.startup_timeout) as watchdog:
        return _training_loop_inner(trainer, batches, cfg, val_dataset, log, stats,
                                    watchdog, part)


def _padded(images, targets, max_gt, part):
    """(images, gt_boxes, gt_labels, gt_valid) of a batch, the GT padded over
    the whole batch and then cut to this rank's part = (rows, band): its
    rows (all when None) and, of the NHWC images, its band of rows (all when
    None)."""
    rows, band = part
    batch = (images, *pad_targets(targets, max_gt))
    if rows is not None:
        batch = tuple(x[rows] for x in batch)
    if band is not None:
        batch = (batch[0][:, band],) + batch[1:]
    return batch


def _training_loop_inner(trainer, batches, cfg, val_dataset, log, stats, watchdog, part):
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

        metrics = trainer.train_step(*_padded(images, targets, cfg.max_gt, part), lr,
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
                loss_val += float(trainer.eval_loss(*_padded(img_e, tgt_e, cfg.max_gt, part)))
                watchdog.beat()
                if n > cfg.eval_batches:
                    break
            eval_losses.append(loss_val / max(n, 1))
            log(f"eval loss = {eval_losses[-1]:.5f}")

        if iteration % cfg.save_point == 0:
            # rank 0 writes (every rank holds the same state); the others
            # drop their copy of the history and wait for the files
            if multihost.is_main():
                path = save_checkpoint(trainer, cfg.save_folder, cfg.name, iteration)
                history.save(f"{cfg.save_folder}/{cfg.name}_loss_{iteration}.npy")
                if eval_losses:
                    np.save(f"{cfg.save_folder}/{cfg.name}_eval_loss_{iteration}.npy",
                            np.array(eval_losses))
                log(f"saved {path}")
            else:
                history.reset()
            eval_losses = []
            multihost.barrier()

    if multihost.is_main():
        save_checkpoint(trainer, cfg.save_folder, cfg.name, cfg.total_iters)
    multihost.barrier()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    stats["wall_s"] = time.perf_counter() - t_loop
    return trainer
