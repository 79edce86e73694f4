"""Data and spatial parallelism on torch.distributed (counterpart of fdt.dist)."""
from fdt_torch.dist import multihost, space
from fdt_torch.dist.mesh import (Mesh, Mesh2D, batch_sharding, make_mesh, make_mesh_2d,
                                 pad_to_mesh, replicated, shard_batch, shard_train_batch,
                                 train_batch_specs)

__all__ = ["make_mesh", "make_mesh_2d", "batch_sharding", "replicated",
           "shard_batch", "shard_train_batch", "train_batch_specs",
           "multihost", "space", "Mesh", "Mesh2D", "pad_to_mesh"]
