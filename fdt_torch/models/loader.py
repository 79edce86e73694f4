"""Carry fdt's flax weights across to the port's modules.

fdt stores variables as a flax tree {"params", "batch_stats"} and writes it as
an npz of f16 `params/...` and f32 `batch_stats/...` arrays
(fdt/models/loader.py:29-70).  Its module names are the reference torch paths
with `.` spelled `__` (fdt/models/torch_convert.py:37-52), so the conversion
is mechanical:

  params/<mod>/kernel  [kH,kW,I,O] → <mod>.weight [O,I,kH,kW]
                       (a depthwise [kH,kW,1,C] → [C,1,kH,kW])
  params/<mod>/bias               → <mod>.bias
  params/<mod>/scale              → <mod>.weight        (BatchNorm γ)
  params/<mod>/negative_slope ()  → <mod>.weight [1]    (PReLU, one slope)
  params/<mod>/kernel  [in,out]   → <mod>.weight [out,in] (Dense → Linear)
  batch_stats/<mod>/mean          → <mod>.running_mean
  batch_stats/<mod>/var           → <mod>.running_var
  (and <mod>.num_batches_tracked = 0, which a strict load expects)

A Linear that takes a flattened feature map (MTCNN's RNet.conv4 and
ONet.conv5) also has its input columns permuted: fdt flattens NHWC, the port
NCHW as the reference does (the `inverse=True` fixup of
fdt/models/mtcnn.py:93-113).

Weights are converted in memory at load time; nothing converted is stored.
The way back (`to_jax_variables`, `save_variables_npz`) writes what the
port trained in fdt's layout, which fdt's load_variables reads.
Every PyramidBox variant, FaceBoxes and the MTCNN nets load this way
(fdt/models/loader.py:102-121 for the detector front doors).

The front doors also read a reference-named torch state dict (`.pth`/`.pt`,
models.torch_convert), as fdt's load_variables does: PyramidBox with
strict=False (fdt/models/loader.py:73), FaceBoxes and MTCNN strict
(fdt/models/loader.py:120, fdt/infer/mtcnn.py:286-288).  save_variables_pth
writes one (fdt/models/loader.py:47-57).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fdt_torch.models.common import NestedSequential
from fdt_torch.models.facebox import FaceBox
from fdt_torch.models.mtcnn import ONet, PNet, RNet
from fdt_torch.models.pyramidbox_mobile import build_pyramidbox
from fdt_torch.models.retinaface import RetinaFace
from fdt_torch.models.torch_convert import (load_reference_state_dict, load_torch_state_dict,
                                            reference_state_dict)

TORCH_SUFFIXES = (".pth", ".pt")

_LEAF_TO_TORCH = {
    "kernel": "weight",
    "bias": "bias",
    "scale": "weight",
    "mean": "running_mean",
    "var": "running_var",
    "negative_slope": "weight",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(variables, flatten_chw: dict | None = None
                       ) -> dict[str, torch.Tensor]:
    """flax {"params", "batch_stats"} tree of numpy arrays → torch state dict
    (float32 tensors).  `flatten_chw` maps a Linear's module path to the
    (C, H, W) of the map it flattens: its kernel's rows come in fdt's (H, W,
    C) order and are permuted to (C, H, W)."""
    flatten_chw = flatten_chw or {}
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            mod = ".".join(path[:-1]).replace("__", ".")
            key = f"{mod}.{_LEAF_TO_TORCH[path[-1]]}"
            w = np.asarray(leaf, np.float32)
            if w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)
            elif w.ndim == 2:
                w = w.T
                if mod in flatten_chw:
                    c, h, wd = flatten_chw[mod]
                    w = w.reshape(-1, h, wd, c).transpose(0, 3, 1, 2).reshape(w.shape)
            elif w.ndim == 0:  # a PReLU's one slope
                w = w.reshape(1)
            sd[key] = torch.from_numpy(np.ascontiguousarray(w))
            if collection == "batch_stats" and path[-1] == "mean":
                sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def flax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """Torch state-dict key → fdt's flax path (collection first), for every
    parameter and running statistic of a model of convolutions, BatchNorms,
    Linears and PReLUs (the PyramidBox family, FaceBoxes, MTCNN's nets);
    num_batches_tracked has none.

    fdt nests a flax module under its parent where the port has a module
    (Bottleneck, SSHContext, InvertedResidual, ...) and joins a Sequential's
    or ModuleList's index to its name with `__` ("downsample__0",
    "features__1", "face_conf__0", "pre_layer__1"), except in a
    NestedSequential, whose numbered children are flax modules of their own
    ("layer1/0")."""
    out: dict[str, tuple[str, ...]] = {}
    leaves = {nn.Conv2d: {"weight": "kernel", "bias": "bias"},
              nn.Linear: {"weight": "kernel", "bias": "bias"},
              nn.BatchNorm2d: {"weight": "scale", "bias": "bias"},
              nn.PReLU: {"weight": "negative_slope"}}

    def walk(module, prefix, path):
        for name, child in module.named_children():
            joined = (isinstance(module, (nn.Sequential, nn.ModuleList))
                      and not isinstance(module, NestedSequential) and path)
            child_path = path[:-1] + (f"{path[-1]}__{name}",) if joined else path + (name,)
            walk(child, f"{prefix}{name}.", child_path)
        kind = next((leaves[t] for t in leaves if isinstance(module, t)), None)
        for name, _ in module.named_parameters(recurse=False):
            if kind is None:
                raise ValueError(f"{prefix}{name}: only convolutions, Linears, PReLUs and "
                                 f"BatchNorm carry back to flax, not {type(module).__name__}")
            out[f"{prefix}{name}"] = ("params",) + path + (kind[name],)
        if isinstance(module, nn.BatchNorm2d):
            out[f"{prefix}running_mean"] = ("batch_stats",) + path + ("mean",)
            out[f"{prefix}running_var"] = ("batch_stats",) + path + ("var",)

    walk(model, "", ())
    return out


def to_flax_array(value: torch.Tensor, path: tuple[str, ...] = (),
                  chw: tuple[int, int, int] | None = None) -> np.ndarray:
    """One torch tensor → its flax leaf (float32 numpy, a copy), the inverse
    of from_jax_variables: conv kernels [O,I,kH,kW] → [kH,kW,I,O], Linear
    weights [out,in] → [in,out] (a Linear over a flattened (C, H, W) map
    has its input columns put back in fdt's (H, W, C) order), a PReLU's
    one slope → a scalar (`path` ends in "negative_slope")."""
    w = value.detach().float().cpu().numpy()
    if w.ndim == 4:
        w = w.transpose(2, 3, 1, 0)
    elif w.ndim == 2:
        if chw is not None:
            c, h, wd = chw
            w = w.reshape(-1, c, h, wd).transpose(0, 2, 3, 1).reshape(w.shape)
        w = w.T
    elif path and path[-1] == "negative_slope":
        w = w.reshape(())
    return np.array(w, order="C", copy=True)


def flax_arrays(model: nn.Module, tensors: dict) -> dict[tuple[str, ...], np.ndarray]:
    """{state-dict key: tensor} of `model` (its state, or optimizer buffers
    shaped like its parameters) → {flax path: flax leaf}; keys without a
    flax path (num_batches_tracked) are dropped."""
    paths = flax_paths(model)
    chw = getattr(model, "flatten_chw", {})
    return {paths[key]: to_flax_array(value, paths[key], chw.get(key.rsplit(".", 1)[0]))
            for key, value in tensors.items() if key in paths}


def to_jax_variables(model: nn.Module) -> dict:
    """The inverse of from_jax_variables: the model's parameters and running
    statistics as fdt's nested {"params", "batch_stats"} tree of float32
    numpy arrays, in flax layout.  num_batches_tracked is carried nowhere."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for (*parents, leaf), value in flax_arrays(model, model.state_dict()).items():
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flat_variables(tree) -> dict[str, np.ndarray]:
    """A nested variables tree → {"params/layer1/0/conv1/kernel": array, ...}:
    the keys of fdt's npz files."""
    return {"/".join(path): np.asarray(v) for path, v in _flatten(tree)}


def save_variables_npz(variables: dict, path: str, dtype=np.float16,
                       compress: bool = True) -> None:
    """Write a {"params", "batch_stats"} tree as fdt's save_variables_npz
    does (fdt/models/loader.py:29-44): `params/...` cast to `dtype` (float16
    by default; a leaf that would overflow float16 stays float32),
    `batch_stats/...` float32, np.savez_compressed (np.savez with
    compress=False: a training checkpoint, where zlib would take seconds a
    save).  fdt's load_variables reads either."""
    def cast(v):
        if dtype == np.float16 and np.abs(v).max() >= np.finfo(np.float16).max:
            return v.astype(np.float32)
        return v.astype(dtype)
    flat = {k: cast(v) if k.startswith("params/") else v.astype(np.float32)
            for k, v in flat_variables({"params": variables["params"],
                                        "batch_stats": variables.get("batch_stats", {})}).items()}
    (np.savez_compressed if compress else np.savez)(path, **flat)


def load_npz(path: str) -> dict:
    """Read a variables npz (fdt's save_variables_npz format) into a nested
    {"params", "batch_stats"} tree of float32 numpy arrays."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key], np.float32)
    out.setdefault("batch_stats", {})
    return out


def save_variables_pth(model_or_variables, path: str) -> None:
    """Write a reference-named torch state dict (fdt's save_variables_pth,
    fdt/models/loader.py:47-57), which the reference's strict
    load_state_dict takes: of a model (torch_convert.reference_state_dict,
    MTCNN's dead heads included) or of a {"params", "batch_stats"} tree in
    fdt's layout (from_jax_variables: a PyramidBox or FaceBoxes tree)."""
    sd = (reference_state_dict(model_or_variables)
          if isinstance(model_or_variables, nn.Module)
          else from_jax_variables(model_or_variables))
    torch.save(sd, path)


def load_weights_file(model: nn.Module, path: str, strict: bool = True) -> nn.Module:
    """`model` with the weights of `path` (its mode and device unchanged):
    a variables npz in fdt's format, loaded strict, or a reference-named
    torch state dict (`.pth`/`.pt`), loaded by load_reference_state_dict
    with `strict`."""
    if str(path).endswith(TORCH_SUFFIXES):
        load_reference_state_dict(model, load_torch_state_dict(path), strict=strict)
    else:
        model.load_state_dict(from_jax_variables(
            load_npz(path), getattr(model, "flatten_chw", None)), strict=True)
    return model


def load_pyramidbox(path: str, variant: str = "repo") -> nn.Module:
    """A full-depth PyramidBox of `variant` (eval mode, CPU, float32) with
    the weights of a variables npz (strict) or of a reference `.pth`
    (strict=False, as fdt's load_variables: a missing key is zero)."""
    return load_weights_file(build_pyramidbox(variant), path, strict=False).eval()


def load_pyramidbox_detector(variant: str, weights: str | None, **kw):
    """A PyramidBoxDetector for any variant with the weights of `weights`
    (load_pyramidbox); torch's default initialisation when it is None
    (fdt's is flax's).  **kw go to the detector (detect_cfg=, budget=,
    dtype=, device=, precision=, quant=, mesh=); with quant="int8" the convs
    are quantized from the loaded float32 weights; mesh= is fdt's
    data-parallel inference over an fdt_torch.dist.Mesh."""
    from fdt_torch.infer.pyramidbox import PyramidBoxDetector
    model = (load_pyramidbox(weights, variant) if weights
             else build_pyramidbox(variant).eval())
    return PyramidBoxDetector(model, variant, **kw)


def load_retinaface(path: str) -> nn.Module:
    """A RetinaFace-ResNet50 (eval mode, CPU, float32) loaded strict from a
    variables npz in fdt's layout or from biubug6/Pytorch_Retinaface's
    state dict (`.pth`/`.pt`: `body.*`, `fpn.*`, `ssh1-3.*`, `ClassHead.*`,
    `BboxHead.*`, `LandmarkHead.*`), with or without the `module.` prefix
    that its released, DataParallel-saved checkpoint carries."""
    model = RetinaFace()
    if not str(path).endswith(TORCH_SUFFIXES):
        return load_weights_file(model, path).eval()
    sd = load_torch_state_dict(path)
    prefix = "module." if sd and all(k.startswith("module.") for k in sd) else ""
    return load_reference_state_dict(model, sd, strict=True, prefix=prefix).eval()


def load_retinaface_detector(path: str, dtype=torch.float32, device=None, budget: int = 5000,
                             detect_cfg=None, quant: str | None = None, **kw):
    """A RetinaFaceDetector (fdt_torch.infer.retinaface) with the weights of
    `path` (load_retinaface), computing in `dtype` (float32, or bfloat16
    channels-last) on `device` (None: the card), `budget` boxes into NMS,
    `detect_cfg` (default: test_widerface.py's settings, RETINA_RES50);
    quant="int8" quantizes the convs from the loaded float32 weights.  **kw
    go to the detector (precision=, mesh=)."""
    from fdt_torch.infer.retinaface import RetinaFaceDetector
    return RetinaFaceDetector(load_retinaface(path), detect_cfg=detect_cfg, budget=budget,
                              dtype=dtype, device=device, quant=quant, **kw)


def load_facebox_detector(weights: str, **kw):
    """A FaceBoxDetector with the weights of a variables npz or a reference
    `.pth`/`.pt`, loaded strict.  **kw go to the detector (budget=, out_k=,
    dtype=, device=, precision=, quant=, mesh=); with quant="int8" the convs
    are quantized from the loaded float32 weights; mesh= is fdt's
    data-parallel inference over an fdt_torch.dist.Mesh."""
    from fdt_torch.infer.facebox import FaceBoxDetector
    return FaceBoxDetector(load_weights_file(FaceBox(), weights).eval(), **kw)


def load_mtcnn_nets(pnet_vars, rnet_vars, onet_vars) -> tuple[nn.Module, ...]:
    """(PNet, RNet, ONet) in eval mode, CPU, float32, each loaded strict from
    its flax variables tree."""
    nets = []
    for model, variables in ((PNet(), pnet_vars), (RNet(), rnet_vars), (ONet(), onet_vars)):
        model.load_state_dict(from_jax_variables(variables, model.flatten_chw), strict=True)
        nets.append(model.eval())
    return tuple(nets)


def load_mtcnn_files(p_path: str, r_path: str, o_path: str) -> tuple[nn.Module, ...]:
    """(PNet, RNet, ONet) in eval mode, CPU, float32, each loaded strict from
    a variables npz in fdt's format or a reference `.pt` file."""
    return tuple(load_weights_file(net(), path).eval()
                 for net, path in ((PNet, p_path), (RNet, r_path), (ONet, o_path)))


def load_mtcnn_cascade(p_path: str, r_path: str, o_path: str, **kw):
    """An MTCNNDeviceCascade from three weight files (PNet, RNet, ONet:
    load_mtcnn_files).  **kw go to the cascade (device=None is the card)."""
    from fdt_torch.infer.mtcnn_device import MTCNNDeviceCascade
    return MTCNNDeviceCascade(*load_mtcnn_files(p_path, r_path, o_path), **kw)
