"""One rank of a data-parallel train-step job of fdt_torch over gloo, for
tests/test_torch_dist_train.py (no JAX here).

    python tests/torch_dist_worker.py <spec.json> <rank>

spec: {"family": "pyramid" | "facebox", "world": n, "port": p,
       "variables": flat variables npz (fdt's layout), "batch": npz of the
       GLOBAL batch (images, gt_boxes, gt_labels, gt_valid),
       "steps": k, "lr": x, "out": directory,
       "perturb": optional rank whose parameters are moved before the steps}

The rank joins the process group, takes its rows of the global batch
(process_batch_bounds), runs k steps and writes <out>/rank<r>.npz: the
step's metrics ("metrics", [k, parts], every rank's global values) and its
variables after the steps ("v/<flax path>").
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fdt_torch.config import FACEBOX  # noqa: E402
from fdt_torch.dist import multihost  # noqa: E402
from fdt_torch.models import FaceBox, build_pyramidbox, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, load_npz, to_jax_variables  # noqa: E402
from fdt_torch.train.facebox_train import FaceBoxTrainer  # noqa: E402
from fdt_torch.train.loops import PyramidTrainer  # noqa: E402

# the FaceBoxes grid of the CPU tests (tests/test_torch_facebox_train.py)
FACEBOX_SMALL = dataclasses.replace(FACEBOX, input_size=128, feature_map_sizes=(4, 2, 1))


def trainer(family: str, variables: dict):
    """The family's trainer on the CPU, float32 "highest", from fdt's
    variables."""
    if family == "pyramid":
        model = build_pyramidbox("try3")
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return PyramidTrainer(model, "try3", input_size=128, precision="highest",
                              device="cpu")
    model = FaceBox()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return FaceBoxTrainer(model, cfg=FACEBOX_SMALL, precision="highest", device="cpu")


def main(spec_path: str, rank: int) -> int:
    spec = json.loads(pathlib.Path(spec_path).read_text())
    multihost.initialize(f"127.0.0.1:{spec['port']}", spec["world"], rank, timeout_s=120)
    try:
        t = trainer(spec["family"], load_npz(spec["variables"]))
        if spec.get("perturb") == rank:  # rank 0's copy must win at the first step
            with torch.no_grad():
                for p in t.model.parameters():
                    p.add_(0.5)
        with np.load(spec["batch"]) as z:
            batch = [z[k] for k in ("images", "gt_boxes", "gt_labels", "gt_valid")]
        lo, hi = multihost.process_batch_bounds(len(batch[0]))
        metrics = []
        for _ in range(spec["steps"]):
            m = t.train_step(*(x[lo:hi] for x in batch), spec["lr"])
            metrics.append([float(v) for v in m.values()])
        out = {f"v/{k}": v for k, v in flat_variables(to_jax_variables(t.model)).items()}
        np.savez(pathlib.Path(spec["out"]) / f"rank{rank}.npz", metrics=np.array(metrics),
                 step=t.step, **out)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
