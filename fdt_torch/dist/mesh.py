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
virtual CPU devices.

The 2-D data × space mesh (make_mesh_2d, training only) is one rank a
device too, n_data × n_space ranks; rank r sits at (data, space) =
divmod(r, n_space), fdt's reshape(n_data, n_space).  A rank holds its data
index's rows of each batch and, at every layer, one band of rows of each
feature map (fdt's P("data", "space") images: the image HEIGHT over
`space`); the halo exchanges XLA's partitioner inserts for fdt are
fdt_torch.dist.space's.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from fdt_torch.dist import multihost, space


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
    axis_names = ("data",)

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


class Mesh2D(Mesh):
    """This rank's view of the 2-D data × space mesh: `devices` are every
    rank's (rank order), `device` its own, `data_index` / `space_index` its
    place, and multihost.space_group() / data_group() its two subgroups."""

    axis_names = ("data", "space")

    def __init__(self, n_data: int, n_space: int, rank: int, devices: Sequence):
        if len(devices) != n_data * n_space:
            raise ValueError(f"a {n_data} x {n_space} mesh takes {n_data * n_space} "
                             f"devices, one a rank; {len(devices)} given")
        super().__init__(devices)
        self.n_data, self.n_space = n_data, n_space
        self._rank = rank
        self.data_index, self.space_index = divmod(rank, n_space)
        self.device = self.devices[rank]

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "space": self.n_space}

    def __repr__(self) -> str:
        return (f"Mesh2D({self.shape}, rank={self.rank} at (data {self.data_index}, "
                f"space {self.space_index}), device={self.device})")


def make_mesh_2d(n_data: int, n_space: int, devices: Sequence | None = None) -> Mesh2D:
    """This rank's view of the n_data × n_space mesh over the process group
    (which must hold n_data × n_space ranks), with its space and data
    subgroups made (multihost.make_mesh_groups; every rank calls this).
    `devices`: one a rank; None → cuda:0..n-1, raising with fewer cards (no
    fall-back to the CPU); a CPU mesh is [torch.device("cpu")] * n."""
    n = n_data * n_space
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise ValueError(f"a {n_data} x {n_space} mesh takes {n} CUDA cards; this "
                             f"machine has {count}.  A CPU mesh is make_mesh_2d(n_data, "
                             "n_space, devices=[torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(n)]
    if multihost.group() is None or torch.distributed.get_world_size() != n:
        raise ValueError(f"make_mesh_2d({n_data}, {n_space}) needs a process group of {n} "
                         "ranks (multihost.initialize), one a device")
    multihost.make_mesh_groups(n_data, n_space)
    return Mesh2D(n_data, n_space, torch.distributed.get_rank(), devices)


def train_batch_specs(mesh: Mesh, n_targets: int = 3) -> tuple:
    """fdt's layouts of one (images, *targets) train batch, as tuples of
    axis names: the images over ("data", "space") (rows, then the HEIGHT
    of NHWC images) on the 2-D mesh, the targets over ("data",); every
    leaf over ("data",) on the 1-D mesh."""
    img = ("data", "space") if "space" in mesh.axis_names else ("data",)
    return (img,) + (("data",),) * n_targets


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


def shard_train_batch(mesh: Mesh, batch) -> list | tuple:
    """An (images, *targets) batch (batch on axis 0, images NHWC; tensors or
    numpy) placed by train_batch_specs.  On the 2-D mesh: this rank's
    tuple, its data index's rows of every leaf and, of the images, its band
    of rows (space.band), on its device.  On the 1-D mesh: shard_batch."""
    if not isinstance(mesh, Mesh2D):
        return shard_batch(mesh, batch)
    lo, hi = multihost.process_batch_bounds(len(batch[0]), mesh.data_index, mesh.n_data)
    out = []
    for x, spec in zip(batch, train_batch_specs(mesh, len(batch) - 1)):
        x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)[lo:hi]
        if "space" in spec:
            a, b = space.band(x.shape[1], mesh.n_space, mesh.space_index)
            x = x[:, a:b]
        out.append(x.to(mesh.device, non_blocking=True))
    return tuple(out)


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
