"""Train PyramidBox (counterpart of scripts/train_pyramid.py, with its flags
and defaults; --device replaces --platform).

  python -m fdt_torch.cli.train_pyramid --net repo --batch_size 7 --lr 2e-5
  python -m fdt_torch.cli.train_pyramid --net try3 --batch_size 16 --lr 1e-4 \\
      --momentum 0.3 --eval_freq 500 --train_pretrain 5000

Runs on the CUDA card unless --device cpu.  Ends with one `[train] {...}`
JSON line: iterations, wall seconds, the seconds the loop waited on the
prefetch queue and the host's augmentation rate.

--journal NAME replays a schedule of the reference's experiment journal
through fdt_torch.cli.train_chained (each phase's lr / momentum / batch_size
as chained processes), passing on the flags fdt's script passes
(scripts/train_pyramid.py:98-121), --device in place of --platform.

Data parallelism, one rank a device (fdt_torch.dist), with fdt's batches:
  --dp_devices n     fdt's one-process mesh: this process starts n local
                     ranks (cuda:0..n-1, or n CPU ranks with --device cpu,
                     over gloo) that run the same seeded pipeline; rank r
                     keeps rows [r·B/n, (r+1)·B/n) of each batch of
                     B = --batch_size rows (so B % n must be 0);
  --num_processes N  N processes the user starts, each with its
                     --process_id and the same --coordinator host:port; each
                     takes its record shard and --batch_size rows a step
                     (global batch N × batch_size) on --device, or else on
                     cuda:<process_id mod cards>; --max_gt is required.
                     --dp_devices is then 0 or N.
  --sp_devices s     fdt's 2-D data x space mesh, with --dp_devices d (0
                     counts as 1): this process starts d·s local ranks,
                     rank r at (data, space) = divmod(r, s), each keeping
                     its data index's rows of each batch (B % d must be 0)
                     and its band of each image's rows; the convolutions'
                     halos are exchanged between the ranks of a data index
                     (fdt_torch.dist.space).  Spatial shards must be
                     process-local: not with --num_processes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from fdt_torch.cli._common import add_device_flag

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="repo",
                    choices=["repo", "try1", "try2", "try3", "try4", "try5"])
    ap.add_argument("--batch_size", default=7, type=int)
    ap.add_argument("--lr", default=2e-5, type=float)
    ap.add_argument("--momentum", default=0.6, type=float)
    ap.add_argument("--iter", default=120000, type=int)
    ap.add_argument("--save_point", default=3000, type=int)
    ap.add_argument("--start_iter", default=0, type=int)
    ap.add_argument("--resume", default=None,
                    help="a variables npz (fdt's format), a torch .pth (loaded as fdt "
                         "loads it, strict=False) or a checkpoint directory of this CLI "
                         "(full state: momentum and step too)")
    ap.add_argument("--eval_freq", default=0, type=int)
    ap.add_argument("--stall_timeout", default=0, type=float,
                    help="seconds without synced step progress before the process "
                         "hard-exits 86; 0 disables; the first step is exempt")
    ap.add_argument("--startup_timeout", default=0, type=float,
                    help="like --stall_timeout, before the first synced step; 0 disables")
    ap.add_argument("--train_pretrain", default=0, type=int,
                    help="freeze the backbone before this iteration (try3-try5)")
    ap.add_argument("--input_size", default=640, type=int,
                    help="train resolution (the reference trains at 640)")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 forward and backward under autocast, "
                         "float32 parameters, optimizer state and loss")
    ap.add_argument("--remat", action="store_true",
                    help="recompute activations in the backward pass: every Bottleneck "
                         "and extra layer on the flagship, the whole forward on the "
                         "mobile variants; same gradients, less activation memory")
    ap.add_argument("--dp_devices", default=0, type=int,
                    help="data-parallel ranks started here, one a device (0 = one "
                         "device); each batch's rows split over them")
    ap.add_argument("--sp_devices", default=1, type=int,
                    help="spatial-partition mesh size: shards the image height over this "
                         "many ranks a data index (the data x space mesh; local ranks only)")
    ap.add_argument("--num_processes", default=1, type=int,
                    help="multi-process data parallelism: start this CLI once a process "
                         "with its --process_id; global batch num_processes x batch_size")
    ap.add_argument("--process_id", default=0, type=int)
    ap.add_argument("--coordinator", default="127.0.0.1:12360",
                    help="host:port of process 0's rendezvous")
    ap.add_argument("--max_gt", default=None, type=int,
                    help="GT pad bucket (required for --num_processes > 1: the "
                         "processes' pads must agree)")
    ap.add_argument("--journal", default=None,
                    help="replay a journal schedule from draw_curve/log (repo | try3 | "
                         "try1) through fdt_torch.cli.train_chained")
    ap.add_argument("--annoPath", default="./image_and_anno/anno/gen_anno_file_train")
    ap.add_argument("--evalAnnoPath", default="./image_and_anno/anno/gen_anno_file_val")
    ap.add_argument("--save_folder", default="weights_of_mine/")
    add_device_flag(ap)
    return ap


def _refuse(args) -> None:
    """fdt's rules for the distribution flags, and the port's one-rank-a-device
    layout."""
    if args.sp_devices > 1 and args.num_processes > 1:
        raise SystemExit("--sp_devices requires single-process runs "
                         "(spatial shards must be process-local)")
    if args.num_processes > 1:
        if args.dp_devices not in (0, args.num_processes):
            raise SystemExit(f"--dp_devices {args.dp_devices} with --num_processes "
                             f"{args.num_processes}: the port runs one rank a device, so "
                             "--dp_devices is 0 or --num_processes")
        if args.max_gt is None:
            raise SystemExit("--num_processes > 1 requires --max_gt: the processes' GT "
                             "pads must agree")
        if not 0 <= args.process_id < args.num_processes:
            raise SystemExit(f"--process_id {args.process_id} is not in "
                             f"[0, {args.num_processes})")
    elif args.dp_devices > 1 and args.batch_size % args.dp_devices:
        raise SystemExit(f"--batch_size {args.batch_size} does not divide over "
                         f"--dp_devices {args.dp_devices}")


def journal_argv(args) -> list[str]:
    """train_chained's arguments for --journal: the flags fdt's script passes
    on (not --save_point: the chained runner derives it a chunk)."""
    argv = ["--net", args.net, "--journal", args.journal, "--iter", str(args.iter),
            "--start_iter", str(args.start_iter), "--save_folder", args.save_folder,
            "--annoPath", args.annoPath]
    if args.resume:
        argv += ["--resume", args.resume]
    argv += ["--input_size", str(args.input_size)]
    if args.device:
        argv += ["--device", args.device]
    if args.stall_timeout:
        argv += ["--stall_timeout", str(args.stall_timeout)]
    if args.startup_timeout:
        argv += ["--startup_timeout", str(args.startup_timeout)]
    return argv


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse(args)
    if args.journal:
        from fdt_torch.cli import train_chained
        return train_chained.main(journal_argv(args))
    if args.num_processes > 1:
        device = _process_device(args.device, args.process_id)
        return _rank(args, args.coordinator, args.num_processes, args.process_id, device,
                     "records")
    if args.dp_devices > 1 or args.sp_devices > 1:
        return _start_local_ranks(args, argv)
    return _train(args, args.device)


def _process_device(device, index: int):
    """--device, or the card index mod the card count."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to train on the CPU")
    return torch.device("cuda", index % torch.cuda.device_count())


def _local_ranks(args) -> int:
    """The ranks --dp_devices d [--sp_devices s] starts: d·s (0 counts as 1)."""
    return max(args.dp_devices, 1) * max(args.sp_devices, 1)


def _start_local_ranks(args, argv) -> int:
    """--dp_devices d [--sp_devices s]: d·s ranks of this CLI (dp_rank_main),
    each on its device, over a fresh local port; their output is this
    process's.  Returns when all have finished; a failure ends them all."""
    import torch

    from fdt_torch.dist import make_mesh, procutil
    n = _local_ranks(args)
    flags = f"--dp_devices {args.dp_devices}" + (
        f" --sp_devices {args.sp_devices}" if args.sp_devices > 1 else "")
    if args.device not in (None, "cpu", "cuda"):
        raise SystemExit(f"{flags} takes cards cuda:0..{n - 1} or, with "
                         f"--device cpu, the CPU; not --device {args.device}")
    if args.device != "cpu":
        try:
            make_mesh(n)
        except ValueError as e:
            raise SystemExit(f"{flags}: {e}") from None
    argv = sys.argv[1:] if argv is None else list(argv)
    coordinator = f"127.0.0.1:{procutil.free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = procutil.child_env(max(1, torch.get_num_threads() // n))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    prog = ("import sys; from fdt_torch.cli.train_pyramid import dp_rank_main; "
            "sys.exit(dp_rank_main(sys.argv[1:]))")
    try:
        procutil.python_workers([["-c", prog, str(r), coordinator, *argv] for r in range(n)],
                                None, env=env, capture=False)
    except procutil.WorkerFailure as e:
        raise SystemExit(f"{flags}: rank {e.index} exited with code "
                         f"{e.returncode}; the others were stopped") from None
    return 0


def dp_rank_main(argv) -> int:
    """One rank of --dp_devices d [--sp_devices s]: `rank coordinator
    *cli_args`."""
    rank, coordinator, *rest = argv
    args = build_parser().parse_args(rest)
    device = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    return _rank(args, coordinator, _local_ranks(args), int(rank), device,
                 "space" if args.sp_devices > 1 else "rows")


def _rank(args, coordinator: str, world: int, rank: int, device, shard: str) -> int:
    """Join the process group as `rank` of `world`, train, leave.  shard
    "space": on the 2-D mesh of --dp_devices x --sp_devices."""
    from fdt_torch.dist import make_mesh, make_mesh_2d, multihost
    multihost.initialize(coordinator, world, rank, device=device)
    try:
        if shard == "space":
            mesh = make_mesh_2d(max(args.dp_devices, 1), args.sp_devices,
                                devices=None if args.device != "cpu" else ["cpu"] * world)
        else:
            mesh = make_mesh(devices=[device])
        return _train(args, device, mesh, shard)
    finally:
        multihost.shutdown()


def _train(args, device, mesh=None, shard: str = "records") -> int:
    import torch

    from fdt_torch.dist import multihost
    from fdt_torch.models import build_pyramidbox
    from fdt_torch.train.checkpoint import load_weights
    from fdt_torch.train.driver import TrainConfig, run_pyramid_training
    from fdt_torch.train.loops import PyramidTrainer, xavier_init

    model = xavier_init(build_pyramidbox(args.net, remat=args.remat and args.net == "repo"), 0)
    freeze = (lambda p: "features" in p) if args.net in ("try3", "try4", "try5") else None
    trainer = PyramidTrainer(model, args.net, momentum=args.momentum,
                             input_size=args.input_size, freeze_predicate=freeze,
                             remat=args.remat and args.net != "repo",
                             dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             device=device)
    if args.resume:
        load_weights(args.resume, trainer, strict=False)
    os.makedirs(args.save_folder, exist_ok=True)
    cfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, total_iters=args.iter,
                      save_point=args.save_point, eval_freq=args.eval_freq,
                      train_pretrain=args.train_pretrain, start_iter=args.start_iter,
                      save_folder=args.save_folder, max_gt=args.max_gt,
                      name=f"{args.net}_pyramid", stall_timeout=args.stall_timeout,
                      startup_timeout=args.startup_timeout)
    stats: dict = {}
    run_pyramid_training(trainer, args.annoPath, cfg,
                         val_anno=args.evalAnnoPath if args.eval_freq else None, mesh=mesh,
                         stats=stats, shard=shard)
    if not multihost.is_main():
        return 0
    ranks = 1 if mesh is None else mesh.world_size
    global_batch = args.batch_size * (ranks if shard == "records" else 1)
    images = stats["iterations"] * global_batch
    print("[train] " + json.dumps({
        "net": args.net, "iterations": stats["iterations"], "step": trainer.step,
        "ranks": ranks, "global_batch": global_batch,
        "wall_s": round(stats["wall_s"], 3), "wait_s": round(stats["wait_s"], 3),
        "wait_share": round(stats["wait_s"] / stats["wall_s"], 4) if stats["wall_s"] else None,
        "augment_images_per_s": (round(stats["augmented"] / stats["augment_s"], 2)
                                 if stats["augment_s"] else None),
        "images_per_s": round(images / stats["wall_s"], 2) if stats["wall_s"] else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
