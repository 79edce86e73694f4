"""fdt_torch's data-parallel train steps (2 gloo ranks) against fdt's DP
steps on fdt.dist.make_mesh(2) (conftest gives JAX 8 virtual CPU devices).

Each job runs tests/torch_dist_worker.py twice, as ranks 0 and 1 of a gloo
group on a fresh port, under procutil's shared deadline; each rank takes its
half of the global batch of 4 at 128², float32 "highest", for 2 steps.  fdt
runs one SPMD step over the same global batch, so three things are global:
BatchNorm's statistics (and its running statistics), the MultiBox loss's
positive count, and the gradient, the sum of each rank's part of the one
loss.

  * Both ranks log the same losses and end with the same parameters and
    running statistics, bit for bit.
  * Both ranks match fdt's DP step with the single-device tolerances of
    tests/test_torch_train_step.py (PyramidBox try3; measured: losses
    1.1e-6 / 1.3e-5 relative at steps 1 / 2, the parameters' change 1.2e-2
    of the largest, the running statistics 8.8e-4) and
    tests/test_torch_facebox_train.py (FaceBoxes at 128², maps 4/2/1;
    measured 1.0e-7 / 9.9e-7, 4.9e-5, 7.5e-6).
  * The batch can show the three faults: its halves hold different numbers
    of faces and different pixel statistics, and the loss that per-rank
    normalisation gives (DistributedDataParallel on the single-device step:
    the mean of each half's own loss) is over 10x the step-1 tolerance away
    from fdt's global loss (measured: 21.45 against 32.94, 35% off).
"""
import dataclasses
import json
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
from fdt.config import FACEBOX as JAX_FACEBOX  # noqa: E402
from fdt.dist import make_mesh, replicated, shard_batch  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.train.facebox_train import FaceBoxTrainer as JaxFaceBoxTrainer  # noqa: E402
from fdt.train.loops import PyramidTrainer as JaxTrainer  # noqa: E402
from fdt.train.loops import TrainState  # noqa: E402
from fdt_torch.dist import procutil  # noqa: E402
from fdt_torch.models import FaceBox  # noqa: E402
from fdt_torch.models.loader import flat_variables  # noqa: E402
from fdt_torch.train.loops import pad_targets  # noqa: E402
from tests import test_torch_facebox_train as fb  # noqa: E402
from tests import test_torch_train_step as ts  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402
from tests.torch_dist_worker import FACEBOX_SMALL  # noqa: E402

torch.set_num_threads(1)

WORKER = REPO / "tests" / "torch_dist_worker.py"
WORLD, BATCH, STEPS = 2, 4, 2
JOB_TIMEOUT_S = 240.0  # shared by both ranks


def pyramid_batch():
    """The global batch: rows 0-1 one face each on darker noise, rows 2-3
    three faces each on noise 40 levels brighter (float16-rounded, as the
    training driver sends images), GT padded to 4 rows."""
    rng = np.random.RandomState(0)
    images = rng.rand(BATCH, 128, 128, 3) * 200 - 117
    images[2:] += 40
    images = images.astype(np.float16).astype(np.float32)
    targets = []
    for i in range(BATCH):
        n = 1 if i < 2 else 3
        xy = rng.rand(n, 2) * 0.6
        wh = 0.1 + rng.rand(n, 2) * 0.3
        targets.append(np.hstack([xy, xy + wh, np.zeros((n, 1))]).astype(np.float32))
    return (images,) + pad_targets(targets, max_gt=4)


def facebox_batch():
    """As pyramid_batch for FaceBoxes (raw 0-255 pixels, labels 1)."""
    rng = np.random.RandomState(1)
    images = rng.randint(0, 200, (BATCH, 128, 128, 3)).astype(np.float32)
    images[2:] += 55
    targets = []
    for i in range(BATCH):
        n = 1 if i < 2 else 3
        wh = 0.15 + rng.rand(n, 2) * 0.35
        xy = rng.rand(n, 2) * (1 - wh)
        targets.append(np.hstack([xy, xy + wh, np.ones((n, 1))]).astype(np.float32))
    gt_boxes, _, gt_valid = pad_targets(targets, max_gt=4)
    return images, gt_boxes, gt_valid.astype(np.int32), gt_valid


def run_job(tmp_path, family: str, variables: dict, batch, lr: float, steps: int = STEPS,
            **extra) -> list:
    """The two ranks' outputs (tests/torch_dist_worker.py)."""
    np.savez(tmp_path / "variables.npz", **flat_variables(variables))
    np.savez(tmp_path / "batch.npz", **dict(zip(("images", "gt_boxes", "gt_labels", "gt_valid"),
                                                batch)))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"family": family, "world": WORLD, "port": procutil.free_port(),
                                "variables": str(tmp_path / "variables.npz"),
                                "batch": str(tmp_path / "batch.npz"), "steps": steps, "lr": lr,
                                "out": str(tmp_path), **extra}))
    procutil.python_workers([[str(WORKER), str(spec), str(r)] for r in range(WORLD)],
                            JOB_TIMEOUT_S, env=procutil.child_env(1), cwd=str(REPO))
    outs = []
    for r in range(WORLD):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({"metrics": z["metrics"], "step": int(z["step"]),
                         "v": {k[2:]: z[k] for k in z.files if k.startswith("v/")}})
    return outs


def fdt_dp_steps(trainer, variables, batch, lr: float) -> dict:
    """fdt's step on make_mesh(2): state replicated, the batch sharded."""
    mesh = make_mesh(WORLD)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    state = jax.device_put(state, replicated(mesh))
    sharded = shard_batch(mesh, batch)
    out = {"metrics": [], "after": []}
    for _ in range(STEPS):
        state, m = trainer.train_step(state, *sharded, lr)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["after"] = flat_variables({"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats)})
    return out


def check_ranks_agree(outs: list) -> None:
    a, b = outs
    np.testing.assert_array_equal(a["metrics"], b["metrics"])
    assert a["v"].keys() == b["v"].keys()
    for k in a["v"]:
        np.testing.assert_array_equal(a["v"][k], b["v"][k], err_msg=k)
    assert a["step"] == b["step"]


def halves_differ(batch) -> None:
    """The batch can tell global from per-rank normalisation: the halves'
    face counts and pixel means differ."""
    images, valid = batch[0], batch[3]
    assert valid[:2].sum() != valid[2:].sum()
    assert abs(images[:2].mean() - images[2:].mean()) > 20


@pytest.fixture(scope="module")
def pyramid_case():
    model = jax_build("try3")
    variables = load_variables(model, str(ts.WEIGHTS), 128)
    trainer = JaxTrainer(model, "try3", input_size=128, precision="highest")
    batch = pyramid_batch()
    return variables, batch, fdt_dp_steps(trainer, variables, batch, ts.LR)


@pytest.mark.watchdog(600)
def test_pyramid_dp_step_matches_fdts_dp_step(tmp_path, pyramid_case):
    variables, batch, fdt = pyramid_case
    outs = run_job(tmp_path, "pyramid", variables, batch, ts.LR)
    check_ranks_agree(outs)
    for step in range(STEPS):
        for j, k in enumerate(ts.PARTS):
            np.testing.assert_allclose(outs[0]["metrics"][step, j], fdt["metrics"][step][k],
                                       rtol=ts.LOSS_RTOL[step], err_msg=f"step {step + 1} {k}")
    ts.check_variables(outs[0]["v"], fdt["after"], flat_variables(variables))


def test_pyramid_batch_tells_global_from_per_rank_normalisation(pyramid_case):
    """DistributedDataParallel's loss on this batch (each half normalised by
    its own positives and BatchNorm statistics, the two averaged) is over
    10x the tolerance away from fdt's global step-1 loss."""
    variables, batch, fdt = pyramid_case
    halves_differ(batch)
    local = [float(ts.port_trainer(variables).eval_loss(*(x[r] for x in batch)))
             for r in (slice(0, 2), slice(2, 4))]
    want = fdt["metrics"][0]["loss"]
    assert abs(np.mean(local) - want) > 10 * ts.LOSS_RTOL[0] * abs(want)


@pytest.mark.watchdog(600)
def test_rank_0_s_parameters_are_broadcast_before_the_first_step(tmp_path, pyramid_case):
    """Rank 1 starts from other parameters: the step takes rank 0's on both
    ranks (fdt's replicated state), so the first step is fdt's."""
    variables, batch, fdt = pyramid_case
    outs = run_job(tmp_path, "pyramid", variables, batch, ts.LR, steps=1, perturb=1)
    check_ranks_agree(outs)
    for j, k in enumerate(ts.PARTS):
        np.testing.assert_allclose(outs[0]["metrics"][0, j], fdt["metrics"][0][k],
                                   rtol=ts.LOSS_RTOL[0], err_msg=k)


@pytest.fixture(scope="module")
def facebox_case():
    seeded = chip_smoke.seeded_variables(FaceBox(), chip_smoke.FACEBOX_WEIGHTS_SEED)
    variables = nest_like(seeded, JaxFaceBox(), 128)
    trainer = JaxFaceBoxTrainer(cfg=dataclasses.replace(JAX_FACEBOX, **fb.SMALL),
                                precision="highest")
    batch = facebox_batch()
    return variables, batch, fdt_dp_steps(trainer, variables, batch, fb.LR)


@pytest.mark.watchdog(600)
def test_facebox_dp_step_matches_fdts_dp_step(tmp_path, facebox_case):
    """fdt's DP FaceBoxes step (tests/test_facebox_train.py's mesh case),
    at tests/test_torch_facebox_train.py's tolerances."""
    variables, batch, fdt = facebox_case
    halves_differ(batch)
    outs = run_job(tmp_path, "facebox", variables, batch, fb.LR)
    check_ranks_agree(outs)
    for step in range(STEPS):
        for j, k in enumerate(fb.PARTS):
            np.testing.assert_allclose(outs[0]["metrics"][step, j], fdt["metrics"][step][k],
                                       rtol=fb.LOSS_RTOL, err_msg=f"step {step + 1} {k}")
    fb.check_variables(outs[0]["v"], fdt["after"], flat_variables(variables))
    assert FACEBOX_SMALL.feature_map_sizes == fb.SMALL["feature_map_sizes"]
