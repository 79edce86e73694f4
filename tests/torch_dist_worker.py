"""One rank of a data-parallel (or data x space) train-step job of fdt_torch
over gloo, for tests/test_torch_dist_train.py and
tests/test_torch_dist_space.py (no JAX here).

    python tests/torch_dist_worker.py <spec.json> <rank>

spec: {"family": "pyramid" | "facebox" | "convcore", "world": n, "port": p,
       "variables": flat variables npz (fdt's layout), "batch": npz of the
       GLOBAL batch (images, gt_boxes, gt_labels, gt_valid),
       "steps": k, "lr": x, "out": directory,
       "perturb": optional rank whose parameters are moved before the steps,
       "space": optional space size s (a (n/s) x s mesh, make_mesh_2d),
       "variant", "size": the PyramidBox variant and input size (try3, 128),
       "remat", "bf16": optional trainer modes,
       "eval": optional, the eval loss before the steps ("eval")}

The rank joins the process group, takes its part of the global batch (its
rows, process_batch_bounds; on the 2-D mesh also its band of the images,
shard_train_batch), runs k steps and writes <out>/rank<r>.npz: the step's
metrics ("metrics", [k, parts], every rank's global values) and its
variables after the steps ("v/<flax path>").

"convcore" is fdt's two-convolution loss of tests/test_dist.py (a 3×3/1
conv, ReLU, a 3×3/2 conv, mean of the squares, "SAME" padding) on the
batch npz's "x" and the variables npz's "k1", "k2" (HWIO) over a 2-D
mesh: it writes the loss and the two kernels' gradients.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fdt_torch.config import FACEBOX  # noqa: E402
from fdt_torch.dist import make_mesh_2d, multihost, shard_train_batch, space  # noqa: E402
from fdt_torch.models import FaceBox, build_pyramidbox, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, load_npz, to_jax_variables  # noqa: E402
from fdt_torch.train.facebox_train import FaceBoxTrainer  # noqa: E402
from fdt_torch.train.loops import PyramidTrainer  # noqa: E402

# the FaceBoxes grid of the CPU tests (tests/test_torch_facebox_train.py)
FACEBOX_SMALL = dataclasses.replace(FACEBOX, input_size=128, feature_map_sizes=(4, 2, 1))


def trainer(family: str, variables: dict, spec: dict | None = None):
    """The family's trainer on the CPU, float32 "highest", from fdt's
    variables."""
    spec = spec or {}
    if family == "pyramid":
        variant = spec.get("variant", "try3")
        model = build_pyramidbox(variant)
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return PyramidTrainer(model, variant, input_size=spec.get("size", 128),
                              precision="highest", device="cpu",
                              remat=spec.get("remat", False),
                              dtype=torch.bfloat16 if spec.get("bf16") else torch.float32)
    model = FaceBox()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return FaceBoxTrainer(model, cfg=FACEBOX_SMALL, precision="highest", device="cpu")


def conv_core(spec: dict, out: pathlib.Path, rank: int) -> None:
    """fdt's two-conv loss on this rank's rows and band: the loss (summed
    over the world) and the kernels' gradients (the same sum), HWIO."""
    world, s = spec["world"], spec["space"]
    mesh = make_mesh_2d(world // s, s, devices=["cpu"] * world)
    with np.load(spec["batch"]) as z:
        b, h, w, _ = z["x"].shape
        (x,) = shard_train_batch(mesh, (z["x"],))
    with np.load(spec["variables"]) as z:
        ks = [torch.from_numpy(z[k].transpose(3, 2, 0, 1).copy()).requires_grad_(True)
              for k in ("k1", "k2")]
    x = x.permute(0, 3, 1, 2)
    # "SAME": a 3×3/1 conv pads 1 on each side; a 3×3/2 conv of an even map
    # pads 0 before and 1 after
    y = torch.relu(space.conv2d(x, ks[0], None, h, 1, ((1, 1), (1, 1))))
    y = space.conv2d(y, ks[1], None, h, 2, ((0, 1), (0, 1)))
    n = b * space.conv_out_height(h, 3, 2, 1, (0, 1)) \
        * space.conv_out_height(w, 3, 2, 1, (0, 1)) * ks[1].shape[0]
    part = (y * y).sum() / n
    part.backward()
    loss = multihost.sum_over_ranks(part.detach())
    grads = [multihost.sum_over_ranks(k.grad).permute(2, 3, 1, 0).numpy() for k in ks]
    np.savez(out / f"rank{rank}.npz", loss=float(loss), g1=grads[0], g2=grads[1],
             coords=np.array([mesh.data_index, mesh.space_index]),
             mesh_shape=np.array([mesh.shape["data"], mesh.shape["space"]]))


def main(spec_path: str, rank: int) -> int:
    spec = json.loads(pathlib.Path(spec_path).read_text())
    multihost.initialize(f"127.0.0.1:{spec['port']}", spec["world"], rank, timeout_s=120)
    try:
        if spec["family"] == "convcore":
            conv_core(spec, pathlib.Path(spec["out"]), rank)
            return 0
        s = spec.get("space", 1)
        mesh = (make_mesh_2d(spec["world"] // s, s, devices=["cpu"] * spec["world"])
                if s > 1 else None)
        t = trainer(spec["family"], load_npz(spec["variables"]), spec)
        if spec.get("perturb") == rank:  # rank 0's copy must win at the first step
            with torch.no_grad():
                for p in t.model.parameters():
                    p.add_(0.5)
        with np.load(spec["batch"]) as z:
            batch = [z[k] for k in ("images", "gt_boxes", "gt_labels", "gt_valid")]
        if mesh is None:
            lo, hi = multihost.process_batch_bounds(len(batch[0]))
            batch = [x[lo:hi] for x in batch]
        else:
            batch = shard_train_batch(mesh, batch)
        extra = {"eval": float(t.eval_loss(*batch))} if spec.get("eval") else {}
        metrics = []
        for _ in range(spec["steps"]):
            m = t.train_step(*batch, spec["lr"])
            metrics.append([float(v) for v in m.values()])
        out = {f"v/{k}": v for k, v in flat_variables(to_jax_variables(t.model)).items()}
        np.savez(pathlib.Path(spec["out"]) / f"rank{rank}.npz", metrics=np.array(metrics),
                 step=t.step, **extra, **out)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
