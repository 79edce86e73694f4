"""Multi-process data parallelism on torch.distributed (counterpart of
fdt/dist/multihost.py).

fdt's processes join one JAX cluster and XLA inserts the collectives.  The
port's ranks join one torch.distributed process group, one rank a device:
NCCL for cards, gloo for the CPU.  While a group exists the training code
takes its global quantities through it (fdt's SPMD graph computes them over
the global batch):

  * every train-mode BatchNorm normalises with the statistics of the global
    batch, through a differentiable all-reduce of [Σx, Σx², count]
    (fdt_torch.models.common.BatchNorm2d);
  * the MultiBox loss divides by the global positive count
    (fdt_torch.train.multibox_loss);
  * the gradients are summed over the ranks after the backward, and the
    logged losses too (fdt_torch.train.loops.DeviceTrainer).

On the 2-D data x space mesh (fdt_torch.dist.mesh.make_mesh_2d) rank r is
at (data, space) = divmod(r, n_space), and two kinds of subgroup join the
ranks: the space group (the ranks of one data index, which share its
images band by band: fdt_torch.dist.space) and the data group (the ranks of
one space index, which together hold each image once: the loss's counts
and the logged metrics are summed over it).  BatchNorm's sums and the
gradient stay over the world.

Typical worker:

    from fdt_torch.dist import make_mesh, multihost
    device = torch.device("cuda", i)
    multihost.initialize("host0:12355", num_processes=N, process_id=i, device=device)
    mesh = make_mesh(devices=[device])
    lo, hi = multihost.process_batch_bounds(global_batch)
    ...
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

# seconds a collective (and the rendezvous) may wait for a peer
TIMEOUT_S = 600.0

# the 2-D mesh's subgroups ("space", "data") while one exists (make_mesh_groups)
_MESH_GROUPS: dict = {}


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device=None, timeout_s: float = TIMEOUT_S, backend: str | None = None) -> None:
    """Join the process group: rank `process_id` of `num_processes`, the
    rendezvous at tcp://coordinator_address (host:port, rank 0 listens).
    `backend` None: NCCL when `device` is a card (made this process's
    current device), gloo otherwise; "gloo" also takes card tensors (it
    stages them through the host).  A second call in the same process
    returns at once, as fdt's; a failed rendezvous raises (nothing carries
    on alone)."""
    if getattr(initialize, "_done", False):
        return
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    initialize._done = True


def shutdown() -> None:
    """Leave the process group (initialize may then be called again)."""
    _MESH_GROUPS.clear()
    if group() is not None:
        dist.destroy_process_group()
    initialize._done = False


def group():
    """The default process group while one exists, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_mesh_groups(n_data: int, n_space: int) -> None:
    """Make the subgroups of the n_data x n_space mesh over the process
    group (every rank calls this, and so new_group, in the same order).
    With n_space 1 there are none: the mesh is the 1-D data-parallel one."""
    d, s = divmod(dist.get_rank(), n_space)
    _MESH_GROUPS.clear()
    if n_space > 1:
        for i in range(n_data):
            g = dist.new_group([i * n_space + j for j in range(n_space)])
            if i == d:
                _MESH_GROUPS["space"] = g
        for j in range(n_space):
            g = dist.new_group([i * n_space + j for i in range(n_data)])
            if j == s:
                _MESH_GROUPS["data"] = g


def space_group():
    """The space subgroup of the 2-D mesh (this rank's data index's ranks),
    or None: no 2-D mesh, or one of space size 1."""
    return _MESH_GROUPS.get("space")


def data_group():
    """The data subgroup of the 2-D mesh (this rank's space index's ranks),
    or None, which collectives read as the world: on the 1-D mesh the data
    axis is the world."""
    return _MESH_GROUPS.get("data")


def process_batch_bounds(global_batch: int, process_id: int | None = None,
                         process_count: int | None = None) -> tuple[int, int]:
    """[lo, hi) rows of the global batch this process loads (contiguous
    blocks, fdt's layout)."""
    n = (dist.get_world_size() if group() is not None else 1) \
        if process_count is None else process_count
    i = (dist.get_rank() if group() is not None else 0) if process_id is None else process_id
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return i * per, (i + 1) * per


def is_main() -> bool:
    """Rank 0, or no process group."""
    return group() is None or dist.get_rank() == 0


def is_data_main() -> bool:
    """Data index 0 (each space index's first rank of its data group), or
    no process group: the rank of its data group that carries a constant of
    the summed loss.  is_main() without a 2-D mesh."""
    if data_group() is None:
        return is_main()
    return dist.get_rank(group=data_group()) == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if group() is not None:
        dist.barrier()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every parameter and buffer of `module` with rank `src`'s,
    in one flat broadcast (nothing without a group)."""
    if group() is None:
        return
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.numel()]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src)
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks of a group; its backward is the Σ of the gradients,
    since every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of `x` over the ranks of `group` (None: the world), differentiable
    (needs a process group)."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of `x` over the ranks of `group` (None: the world) in a new tensor,
    no gradient; `x` itself without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x
