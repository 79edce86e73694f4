"""Data parallelism on torch.distributed (counterpart of fdt.dist)."""
from fdt_torch.dist import multihost
from fdt_torch.dist.mesh import (Mesh, batch_sharding, make_mesh, make_mesh_2d, pad_to_mesh,
                                 replicated, shard_batch, shard_train_batch, train_batch_specs)

__all__ = ["make_mesh", "make_mesh_2d", "batch_sharding", "replicated",
           "shard_batch", "shard_train_batch", "train_batch_specs",
           "multihost", "Mesh", "pad_to_mesh"]
