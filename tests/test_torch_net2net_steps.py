"""fdt_torch's net2net train step against fdt's (fdt/train/net2net.py),
each mode: try1 → try1 (fdt's own test takes the same pair) at 160², batch
2, float32 precision "highest", from seeded weights (student seed 0,
teacher seed 1), at lr 1e-7, 3 steps.  (The models' taps, the CLI and the
checkpoints are in tests/test_torch_net2net.py; fdt's three compiles are
here, apart, so that the parallel run spreads them.)

At 128² try1's last map is 1×1, so train-mode BatchNorm normalises two
values a channel: there the two packages' float32 gradients differ by 7% of
the step's largest change at step 1; at 160² by 0.4-1.5%.  Tolerances,
with what they measured at 160² (the worst mode and step):
  * the loss and its parts within 1e-4 relative (measured 1.5e-5);
  * each parameter's change within 5e-2 of the largest change of any leaf
    (measured 1.5e-2), the running statistics within 5e-3 of each leaf's
    largest value (measured 2.0e-4).
"""
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.train.loops import TrainState  # noqa: E402
from fdt.train.net2net import Net2NetTrainer as JaxTrainer  # noqa: E402
from fdt_torch.models import build_pyramidbox, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, to_jax_variables  # noqa: E402
from fdt_torch.train.net2net import Net2NetTrainer  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

SIZE, BATCH, STEPS, LR = 160, 2, 3, 1e-7
LOSS_RTOL, CHANGE_RTOL, STATS_RTOL = 1e-4, 5e-2, 5e-3
N_PARTS = {"intermedia": 6, "source": 6, "overall": 4}


def port_model(flat: dict):
    model = build_pyramidbox("try1")
    model.load_state_dict(from_jax_variables(flat), strict=True)
    return model


def make_images(seed: int = 0, size: int = SIZE, b: int = BATCH) -> np.ndarray:
    """The prefetcher's batch: mean-subtracted images in float16."""
    return chip_smoke.net2net_batch(seed, b, size)[0]


@functools.lru_cache(maxsize=None)
def fdt_run(mode: str) -> dict:
    """fdt's Net2NetTrainer, try1 → try1 at 160² from the seeded weights: the
    metrics and variables after each step."""
    student = nest_like(chip_smoke.seeded_variables(build_pyramidbox("try1"), 0),
                        jax_build("try1"), SIZE)
    teacher = nest_like(chip_smoke.seeded_variables(build_pyramidbox("try1"), 1),
                        jax_build("try1"), SIZE)
    trainer = JaxTrainer(jax_build("try1"), jax_build("try1"), mode, input_size=SIZE,
                         precision="highest")
    trainer.teacher_variables = jax.tree.map(jnp.asarray, teacher)
    params = jax.tree.map(jnp.asarray, student["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, student["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    out = {"before": flat_variables(student), "metrics": [], "after": []}
    for _ in range(STEPS):
        state, m = trainer.train_step(state, make_images(), LR)
        out["metrics"].append(np.concatenate([[float(m["loss"])], np.asarray(m["parts"])]))
        out["after"].append(flat_variables({"params": jax.device_get(state.params),
                                            "batch_stats": jax.device_get(state.batch_stats)}))
    return out


def port_trainer(mode: str, **kw) -> Net2NetTrainer:
    student = port_model(chip_smoke.seeded_variables(build_pyramidbox("try1"), 0))
    teacher = port_model(chip_smoke.seeded_variables(build_pyramidbox("try1"), 1))
    return Net2NetTrainer(student, teacher, mode, input_size=SIZE, precision="highest",
                          device="cpu", **kw)


@pytest.mark.parametrize("mode", ["intermedia", "source", "overall"])
def test_net2net_steps_match_fdt(mode):
    """The loss and its parts at every step, the student's params and
    batch_stats after each; the teacher never moves."""
    want = fdt_run(mode)
    trainer = port_trainer(mode)
    teacher_before = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    for step in range(STEPS):
        m = trainer.train_step(make_images(), LR)
        assert m["parts"].shape == (N_PARTS[mode],)
        got = np.concatenate([[float(m["loss"])], m["parts"].numpy()])
        np.testing.assert_allclose(got, want["metrics"][step], rtol=LOSS_RTOL,
                                   err_msg=f"step {step + 1}")
        after, before = want["after"][step], want["before"]
        ours = flat_variables(to_jax_variables(trainer.model))
        scale = max(np.abs(after[k] - before[k]).max() for k in after if k.startswith("params/"))
        for k in after:
            if k.startswith("params/"):
                np.testing.assert_allclose(ours[k] - before[k], after[k] - before[k], rtol=0,
                                           atol=CHANGE_RTOL * scale, err_msg=k)
            else:
                np.testing.assert_allclose(ours[k], after[k], rtol=0,
                                           atol=STATS_RTOL * np.abs(after[k]).max(), err_msg=k)
    assert not trainer.teacher.training
    assert not any(p.requires_grad for p in trainer.teacher.parameters())
    for k, v in trainer.teacher.state_dict().items():
        torch.testing.assert_close(v, teacher_before[k], rtol=0, atol=0)
