"""Reference-named torch state dicts, both ways (counterpart of
fdt/models/torch_convert.py).

The port's modules are named after the reference's torch module paths, so a
reference `.pth`/`.pt` state dict loads into them key for key: no layout
transpose and no flatten fixup (the port flattens NCHW, as the reference
does).  What fdt's torch_to_flax / flax_to_torch add on top of a plain
load_state_dict / state_dict is kept here:

  load_reference_state_dict  a `prefix` ("module.") stripped; a shape
                             mismatch raises; strict=True raises on a missing
                             key; strict=False fills a missing key with zeros,
                             the value of fdt's zero template
                             (fdt/models/loader.py:10-14) that its
                             load_variables leaves there; the reference's dead
                             heads (`reference_extras`) are skipped.
  reference_state_dict       float32 contiguous tensors, a PReLU slope of shape
                             (1,), `num_batches_tracked` = 0 beside every
                             BatchNorm, and the dead heads zero-filled, so
                             that the reference's strict load_state_dict
                             passes.
"""
from __future__ import annotations

import pickle
from typing import Callable, Mapping

import torch
from torch import nn

BATCHES = "num_batches_tracked"


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A `.pth`/`.pt` state dict as {name: tensor} on the CPU, without the
    BatchNorms' `num_batches_tracked` (fdt/models/torch_convert.py:26-33).
    Loaded with weights_only=True, so a file that pickles a whole module (a
    class of the reference's code, which fdt would unpickle and ask for its
    state_dict()) is refused with a message saying so; it is never loaded
    with weights_only=False."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: torch.load(weights_only=True) refuses it: it pickles "
                         "more than tensors (a whole module?).  Save its state_dict() "
                         "and pass that file") from e
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
    return {k: v.detach() for k, v in sd.items() if not k.endswith(BATCHES)}


def load_reference_state_dict(model: nn.Module, state_dict: Mapping, strict: bool = True,
                              prefix: str = "",
                              transforms: Mapping[str, Callable] | None = None) -> nn.Module:
    """Load a reference-named state dict into `model` with the semantics of
    fdt's torch_to_flax (fdt/models/torch_convert.py:56-96); returns the model.

    Every parameter and running statistic of the model is read from
    `state_dict[prefix + key]` (after `transforms[key]`, if given) and cast to
    the model's dtype; a one-element tensor takes the model's shape (a PReLU
    slope saved as a scalar).  A shape mismatch raises ValueError.  A missing
    key raises KeyError under strict=True and is zero-filled under
    strict=False.  Keys of the state dict that the model does not define are
    ignored under strict=False; under strict=True only the reference's dead
    heads (the model's `reference_extras`) are, and any other raises
    KeyError.  `num_batches_tracked` is neither read nor required.
    """
    transforms = transforms or {}
    own = model.state_dict()
    new, missing = {}, []
    for key, cur in own.items():
        if key.endswith(BATCHES):
            new[key] = cur
            continue
        src = state_dict.get(prefix + key)
        if src is None:
            missing.append(prefix + key)
            new[key] = torch.zeros_like(cur)
            continue
        w = torch.as_tensor(src)
        if key in transforms:
            w = torch.as_tensor(transforms[key](w))
        if w.numel() == 1 and cur.numel() == 1:
            w = w.reshape(cur.shape)
        if w.shape != cur.shape:
            raise ValueError(f"shape mismatch for {prefix + key}: file {tuple(w.shape)} vs "
                             f"model {tuple(cur.shape)}")
        new[key] = w.to(cur.dtype)
    if strict:
        if missing:
            raise KeyError(f"missing torch keys: {missing[:10]}"
                           f"{' …' if len(missing) > 10 else ''}")
        dead = getattr(model, "reference_extras", {})
        unexpected = [k for k in state_dict if not k.endswith(BATCHES)
                      and not (k.startswith(prefix) and (k[len(prefix):] in own
                                                         or k[len(prefix):] in dead))]
        if unexpected:
            raise KeyError(f"unexpected torch keys: {unexpected[:10]}"
                           f"{' …' if len(unexpected) > 10 else ''}")
    with torch.no_grad():
        model.load_state_dict(new, strict=True)
    return model


def reference_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state as the reference's torch modules hold it (fdt's
    flax_to_torch, fdt/models/torch_convert.py:99-139): float32 contiguous
    CPU copies, `num_batches_tracked` = 0 (int64) beside every BatchNorm, and
    zero-filled dead heads (`reference_extras`, fdt's mtcnn_export_extras)."""
    sd = {k: torch.zeros(shape, dtype=torch.float32)
          for k, shape in getattr(model, "reference_extras", {}).items()}
    for key, value in model.state_dict().items():
        if key.endswith(BATCHES):
            sd[key] = torch.tensor(0, dtype=torch.int64)
        else:
            sd[key] = value.detach().to("cpu", torch.float32).clone().contiguous()
    return sd
