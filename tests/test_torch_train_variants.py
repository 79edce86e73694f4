"""One train step of every mobile PyramidBox variant on the CPU, from fdt's
init rules (xavier_init): the head-supervision branch is computed only when
the trainer asks (tests/test_torch_mobile.py::test_forward_matches_flax
holds it to fdt's), the trainer's priors cover exactly the model's outputs,
and the step's losses are finite.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt_torch.models import build_pyramidbox  # noqa: E402
from fdt_torch.train.loops import PyramidTrainer, xavier_init  # noqa: E402

torch.set_num_threads(1)

SIZE = 128


@pytest.mark.parametrize("variant", ["try1", "try2", "try3", "try4", "try5"])
def test_a_step_of_each_variant_trains(variant):
    model = xavier_init(build_pyramidbox(variant), 0)
    x = torch.zeros(1, 3, SIZE, SIZE)
    with torch.no_grad():
        plain, heads = model.eval()(x), model(x, heads=True)
    assert "head_loc" not in plain  # the detect path computes no head branch
    trainer = PyramidTrainer(model, variant, input_size=SIZE, device="cpu")
    assert len(trainer.priors_face) == heads["face_loc"].shape[1]
    assert len(trainer.priors_head) == heads["head_loc"].shape[1] == heads["head_conf"].shape[1]
    m = trainer.train_step(*chip_smoke.train_batch(2, 2, SIZE), 1e-4)
    assert all(np.isfinite(float(v)) for v in m.values()) and trainer.step == 1
