"""Training checkpoints without orbax (counterpart of fdt/train/checkpoint.py).

A checkpoint is the directory `<directory>/<name>_<step>` (the name that
latest_checkpoint finds, as fdt's orbax directories are named), holding

  variables.npz  the model's params and batch_stats in fdt's npz layout
                 (save_variables_npz), params in float32 so that a resume
                 keeps the master weights, not compressed (zlib over the
                 flagship's float32 weights held the loop for seconds a
                 save); fdt's load_variables reads it;
  opt_state.npz  `momentum/<flax path>`: the SGD momentum buffers in flax
                 layout, and `step`.

restore_checkpoint loads both back into a trainer, which resumes exactly.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from fdt_torch.models.loader import (flax_paths, from_jax_variables, load_npz,
                                     save_variables_npz, to_flax_array,
                                     to_jax_variables)

VARIABLES, OPT_STATE = "variables.npz", "opt_state.npz"


def save_checkpoint(trainer, directory: str, name: str, step: int) -> str:
    """Write `<directory>/<name>_<step>` (e.g. repo_pyramid_3000); returns
    its absolute path."""
    path = os.path.abspath(os.path.join(directory, f"{name}_{step}"))
    os.makedirs(path, exist_ok=True)
    save_variables_npz(to_jax_variables(trainer.model), os.path.join(path, VARIABLES),
                       dtype=np.float32, compress=False)
    paths = flax_paths(trainer.model)
    opt = {"step": np.int64(trainer.step)}
    for key, p in trainer.model.named_parameters():
        buf = trainer.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            opt["momentum/" + "/".join(paths[key][1:])] = to_flax_array(buf)
    np.savez(os.path.join(path, OPT_STATE), **opt)
    return path


def restore_checkpoint(path: str, trainer):
    """Load a checkpoint directory into `trainer`: the model's variables
    (strict), the momentum buffers and the step.  Returns the trainer."""
    sd = from_jax_variables(load_npz(os.path.join(path, VARIABLES)))
    trainer.model.load_state_dict(sd, strict=True)
    with np.load(os.path.join(path, OPT_STATE)) as z:
        trainer.step = int(z["step"])
        momentum = {"params": {}}
        for key in z.files:
            if key.startswith("momentum/"):
                node = momentum["params"]
                *parents, leaf = key.split("/")[1:]
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
    buffers = from_jax_variables(momentum)
    for key, p in trainer.model.named_parameters():
        if key in buffers:
            trainer.optimizer.state[p]["momentum_buffer"] = buffers[key].to(p.device, p.dtype)
    return trainer


def latest_checkpoint(directory: str, name: str):
    """Highest-step checkpoint path or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(re.escape(name) + r"_(\d+)$")
    best, best_step = None, -1
    for entry in os.listdir(directory):
        m = pat.match(entry)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, entry), int(m.group(1))
    return best


def load_weights(path: str, trainer) -> None:
    """--resume of the port's CLI: a checkpoint directory (full state) or a
    variables npz in fdt's format (params and batch_stats only)."""
    if os.path.isdir(path):
        restore_checkpoint(path, trainer)
        return
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port reads a variables npz or a checkpoint "
                         "directory (a .pth or an orbax directory is not readable here)")
    sd = from_jax_variables(load_npz(path))
    with torch.no_grad():
        trainer.model.load_state_dict(sd, strict=True)
