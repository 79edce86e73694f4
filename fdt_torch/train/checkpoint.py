"""Training checkpoints without orbax (counterpart of fdt/train/checkpoint.py).

A checkpoint is the directory `<directory>/<name>_<step>` (the name that
latest_checkpoint finds, as fdt's orbax directories are named), holding

  variables.npz  the model's params and batch_stats in fdt's npz layout
                 (save_variables_npz), params in float32 so that a resume
                 keeps the master weights, not compressed (zlib over the
                 flagship's float32 weights held the loop for seconds a
                 save); fdt's load_variables reads it (MTCNN's nets have
                 params only);
  opt_state.npz  the optimizer's state under flax paths, and `step`:
                 SGD's momentum buffers as `momentum/<path>`; Adam's first
                 and second moments as optax's `mu/<path>` and `nu/<path>`,
                 with its step count as `count`.

restore_checkpoint loads both back into a trainer, which resumes exactly.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from fdt_torch.models.loader import (TORCH_SUFFIXES, flax_paths, from_jax_variables,
                                     load_npz, load_weights_file, save_variables_npz,
                                     to_flax_array, to_jax_variables)

VARIABLES, OPT_STATE = "variables.npz", "opt_state.npz"
# torch optimizer state key → its opt_state.npz prefix (SGD, Adam)
_BUFFERS = {"momentum_buffer": "momentum", "exp_avg": "mu", "exp_avg_sq": "nu"}


def save_checkpoint(trainer, directory: str, name: str, step: int) -> str:
    """Write `<directory>/<name>_<step>` (e.g. repo_pyramid_3000); returns
    its absolute path."""
    path = os.path.abspath(os.path.join(directory, f"{name}_{step}"))
    os.makedirs(path, exist_ok=True)
    save_variables_npz(to_jax_variables(trainer.model), os.path.join(path, VARIABLES),
                       dtype=np.float32, compress=False)
    paths = flax_paths(trainer.model)  # one walk of the model for every buffer
    chw = getattr(trainer.model, "flatten_chw", {})
    opt = {"step": np.int64(trainer.step)}
    for key, p in trainer.model.named_parameters():
        state = trainer.optimizer.state.get(p, {})
        for buf, prefix in _BUFFERS.items():
            if buf in state:
                opt[prefix + "/" + "/".join(paths[key][1:])] = to_flax_array(
                    state[buf], paths[key], chw.get(key.rsplit(".", 1)[0]))
        if "step" in state:  # Adam: one count for every parameter, as optax keeps it
            opt["count"] = np.int64(float(state["step"]))
    np.savez(os.path.join(path, OPT_STATE), **opt)
    return path


def _model_state(model, variables: dict) -> dict:
    return from_jax_variables(variables, getattr(model, "flatten_chw", None))


def restore_checkpoint(path: str, trainer):
    """Load a checkpoint directory into `trainer`: the model's variables
    (strict), the optimizer's buffers and the step.  Returns the trainer."""
    trainer.model.load_state_dict(
        _model_state(trainer.model, load_npz(os.path.join(path, VARIABLES))), strict=True)
    buffers = {}
    with np.load(os.path.join(path, OPT_STATE)) as z:
        trainer.step = int(z["step"])
        count = int(z["count"]) if "count" in z.files else None
        for buf, prefix in _BUFFERS.items():
            tree = {"params": {}}
            for key in z.files:
                if key.startswith(prefix + "/"):
                    node = tree["params"]
                    *parents, leaf = key.split("/")[1:]
                    for p in parents:
                        node = node.setdefault(p, {})
                    node[leaf] = z[key]
            buffers[buf] = _model_state(trainer.model, tree)
    for key, p in trainer.model.named_parameters():
        state = {buf: b[key].to(p.device, p.dtype) for buf, b in buffers.items() if key in b}
        if state:
            if count is not None:
                state["step"] = torch.tensor(float(count))
            trainer.optimizer.state[p] = state
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


def _variables_file(path: str) -> str:
    """A checkpoint directory's variables npz, or `path` itself when it is a
    variables npz or a torch `.pth`/`.pt` state dict."""
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, VARIABLES)):
            raise ValueError(f"{path}: no {VARIABLES} (an orbax directory is not "
                             "readable here)")
        return os.path.join(path, VARIABLES)
    if not path.endswith((".npz",) + TORCH_SUFFIXES):
        raise ValueError(f"{path}: the port reads a variables npz, a torch .pth/.pt "
                         "state dict or a checkpoint directory")
    return path


def read_variables(path: str, model: torch.nn.Module | None = None) -> dict:
    """A model's variables as fdt's {"params", "batch_stats"} tree: from a
    variables npz in fdt's format, a checkpoint directory of the port, or a
    reference-named torch `.pth`/`.pt` state dict, which is read through
    `model` (loaded strict into it, then to_jax_variables).  An orbax
    directory is refused."""
    path = _variables_file(path)
    if path.endswith(TORCH_SUFFIXES):
        if model is None:
            raise ValueError(f"{path}: a torch state dict is read through the model it "
                             "belongs to (pass model=)")
        return to_jax_variables(load_weights_file(model, path))
    return load_npz(path)


def load_model_weights(path: str, model: torch.nn.Module,
                       strict: bool = True) -> torch.nn.Module:
    """The weights of a variables npz, a checkpoint directory or a torch
    `.pth`/`.pt` (loader.load_weights_file; `strict` applies to the `.pth`,
    an npz loads strict) loaded into `model`; returns it."""
    return load_weights_file(model, _variables_file(path), strict)


def load_weights(path: str, trainer, strict: bool = True) -> None:
    """--resume of the port's CLIs: a checkpoint directory (full state), or
    a variables npz in fdt's format or a torch `.pth`/`.pt` state dict
    (params and batch_stats only; `strict` applies to the `.pth`)."""
    if os.path.isdir(path):
        restore_checkpoint(path, trainer)
        return
    load_model_weights(path, trainer.model, strict)
