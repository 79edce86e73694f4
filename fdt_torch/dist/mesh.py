"""Devices and batch sharding for data parallelism (counterpart of
fdt/dist/mesh.py).

fdt builds a 1-D `jax.sharding.Mesh` and lets XLA's SPMD partitioner
insert the collectives.  In the port a Mesh is the list of devices one
process drives, along the `data` axis:

  * inference: one process drives several devices; the detectors replicate
    their model to each (`replicated`), split every batch along axis 0
    (`shard_batch`) and run the shards one after another without waiting
    for the card;
  * training: one process a device (one rank a card), joined by a
    torch.distributed process group (fdt_torch.dist.multihost); the mesh
    of a rank holds its one device, and `rank` / `world_size` are the
    group's.

make_mesh takes cards only: fewer cards than asked raises, where fdt falls
back to virtual CPU devices.  A CPU mesh is asked for by name,
make_mesh(devices=[torch.device("cpu")] * n), as fdt's tests ask for
virtual CPU devices.  The 2-D data × space mesh is the next slice
(ROADMAP Queue 1 item 5): in PyTorch every convolution's halo exchange is
written by hand.
"""
from __future__ import annotations

import copy
from typing import Sequence

import torch

from fdt_torch.dist import multihost

_DATA_SPACE = ("the data x space mesh (image height sharded, convolution halos "
               "exchanged) is the next slice of the port: ROADMAP Queue 1 item 5")


def canonical_device(device) -> torch.device:
    """torch.device(device), a card without an index given the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """The devices this process drives along one data-parallel axis.

    `devices` may repeat a device (several slots on one card or on the
    CPU); `rank` and `world_size` are those of the torch.distributed
    process group once one exists (0 and 1 before)."""

    axis_name = "data"

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(canonical_device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def rank(self) -> int:
        return 0 if multihost.group() is None else torch.distributed.get_rank()

    @property
    def world_size(self) -> int:
        return 1 if multihost.group() is None else torch.distributed.get_world_size()

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_name!r}, "
                f"rank={self.rank}, world_size={self.world_size})")


def make_mesh(n: int | None = None, devices: Sequence | None = None) -> Mesh:
    """A 1-D data-parallel mesh over the first `n` CUDA cards (all of them
    when n is None), or over `devices` (their first n when n is given).
    Raises if there are fewer than n cards (or devices): there is no
    fall-back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = count if n is None else n
        if want < 1 or count < want:
            raise ValueError(f"requested {want if n is not None else 'every'} CUDA "
                             f"card(s); this machine has {count}.  A CPU mesh is "
                             "make_mesh(devices=[torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(want)]
    elif n is not None:
        if len(devices) < n:
            raise ValueError(f"requested {n} devices; {len(devices)} given")
        devices = list(devices)[:n]
    return Mesh(devices)


def make_mesh_2d(n_data: int, n_space: int) -> Mesh:
    """Refused: the 2-D data × space mesh is not ported yet."""
    raise NotImplementedError(f"make_mesh_2d: {_DATA_SPACE}")


def train_batch_specs(mesh: Mesh, n_targets: int = 3):
    """Refused: the images' (data, space) layout belongs to the 2-D mesh."""
    raise NotImplementedError(f"train_batch_specs: {_DATA_SPACE}")


def batch_sharding(mesh: Mesh, batch: int) -> list[slice]:
    """The rows of a `batch` each device of the mesh takes, contiguous
    blocks in device order (fdt's P("data") layout).  Raises unless the
    batch divides over the mesh, as fdt's sharding refuses it."""
    if batch % mesh.size:
        raise ValueError(f"batch {batch} does not divide over the mesh's "
                         f"{mesh.size} devices")
    per = batch // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def pad_to_mesh(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` (batch on axis 0) with its last row repeated up to a multiple of
    the mesh's size, as fdt's detectors pad."""
    pad = -len(x) % mesh.size
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


def shard_batch(mesh: Mesh, tree) -> list:
    """A batch (a tensor, or a tuple / list of them, batch on axis 0) split
    along axis 0 over the mesh: one tree a device, moved there.  Raises
    unless the batch divides over the mesh."""
    leaves = tree if isinstance(tree, (tuple, list)) else (tree,)
    rows = batch_sharding(mesh, len(leaves[0]))
    shards = []
    for device, r in zip(mesh.devices, rows):
        part = tuple(x[r].to(device, non_blocking=True) for x in leaves)
        shards.append(part if isinstance(tree, (tuple, list)) else part[0])
    return shards


# fdt places (images, *targets) by train_batch_specs; on a 1-D mesh every
# leaf shards over `data`, which is shard_batch
shard_train_batch = shard_batch


def run_sharded(mesh: Mesh, fn, batch: torch.Tensor, home: torch.device):
    """fn(device, shard) on each device's shard of `batch` (its last row
    repeated up to a mesh multiple), launched one after another without
    waiting for a card; the outputs (a tensor or a tuple of them, batch on
    axis 0) gathered on `home` and cut back to the batch's rows."""
    b = len(batch)
    outs = [fn(d, s) for d, s in zip(mesh.devices, shard_batch(mesh, pad_to_mesh(mesh, batch)))]
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(home) for o in outs])[:b]
    return tuple(torch.cat([o[i].to(home) for o in outs])[:b] for i in range(len(outs[0])))


def replicated(mesh: Mesh, module: torch.nn.Module) -> dict:
    """A copy of `module` on each distinct device of the mesh, keyed by
    device: the module itself where it already lies, a deep copy moved
    there elsewhere (int8 convs carry their packed weights along)."""
    params = list(module.parameters()) or list(module.buffers())
    home = canonical_device(params[0].device) if params else None
    return {d: module if d == home else copy.deepcopy(module).to(d) for d in mesh.distinct}
