"""fdt_torch's data x space mesh (gloo ranks on the CPU) against fdt's on
fdt.dist.make_mesh_2d (conftest gives JAX 8 virtual CPU devices).

Each job runs tests/torch_dist_worker.py as the ranks of a gloo group on a
fresh port, under procutil's shared deadline; rank r sits at (data, space) =
divmod(r, n_space) and holds its data index's rows with the images cut to
its band of rows.

  * The conv core: fdt's two-convolution loss of tests/test_dist.py (3×3/1,
    ReLU, 3×3/2, "SAME"), which fdt calls the correctness core of its mesh,
    on 1 x 4 and 2 x 2 meshes: loss and gradients against fdt's jitted run
    on its 2 x 4 mesh within fdt's rtol 1e-5 / atol 1e-6.
  * The whole step: try3 at 64² (a 1-row last map, so one of two bands is
    empty) and try4 at 64² (an odd 15-row map under the upsample's crop,
    maps grown by 2 rows by its 1×1/pad-1 smooths), global batch 4, float32
    "highest", 2 steps on a 2 x 2 mesh, against fdt's PyramidTrainer step on
    make_mesh_2d(2, 2) within the data-parallel tests' tolerances
    (tests/test_torch_train_step.py's); the 4 ranks end bit-equal; a
    space-only 1 x 2 run equals the port's one-device step within the same
    tolerances.
  * The CLI: train_pyramid --dp_devices 2 --sp_devices 2 --device cpu writes
    a checkpoint the port's loader reads.
"""
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
from fdt.dist import make_mesh_2d, replicated, shard_train_batch  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt.train.loops import PyramidTrainer as JaxTrainer  # noqa: E402
from fdt.train.loops import TrainState  # noqa: E402
from fdt_torch.cli import train_pyramid  # noqa: E402
from fdt_torch.dist import procutil  # noqa: E402
from fdt_torch.models import build_pyramidbox  # noqa: E402
from fdt_torch.models.loader import flat_variables, to_jax_variables  # noqa: E402
from fdt_torch.train.checkpoint import load_model_weights  # noqa: E402
from fdt_torch.train.loops import pad_targets  # noqa: E402
from tests import test_torch_train_step as ts  # noqa: E402
from tests.test_torch_dist import mini_train  # noqa: E402,F401 — a fixture
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

WORKER = REPO / "tests" / "torch_dist_worker.py"
SIZE, BATCH, STEPS = 64, 4, 2
# try3 takes the data-parallel tests' lr.  try4's seeded weights (no weight
# file) take a step 10x larger at it (face_loc 33.4 → 26.5), where float32
# noise alone puts fdt's and the port's ONE-device steps 2.2e-3 apart at
# step 2 (measured), over LOSS_RTOL; at the golden's lr 1e-6 they are
# 1.9e-4 apart, within it
LR = {"try3": ts.LR, "try4": chip_smoke.TRAIN_LR}
JOB_TIMEOUT_S = 240.0  # shared by a job's ranks


def run_job(tmp_path, spec: dict, arrays: dict, batch: dict) -> list:
    """The ranks' rank<r>.npz contents (tests/torch_dist_worker.py)."""
    np.savez(tmp_path / "variables.npz", **arrays)
    np.savez(tmp_path / "batch.npz", **batch)
    world = spec["world"]
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({"port": procutil.free_port(), "out": str(tmp_path),
                                "variables": str(tmp_path / "variables.npz"),
                                "batch": str(tmp_path / "batch.npz"), **spec}))
    procutil.python_workers([[str(WORKER), str(path), str(r)] for r in range(world)],
                            JOB_TIMEOUT_S, env=procutil.child_env(1), cwd=str(REPO))
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


# -- the conv core (tests/test_dist.py::test_spatial_conv_gradient_matches_single_device)

@pytest.fixture(scope="module")
def conv_core():
    """fdt's two-conv loss and gradients, jitted on make_mesh_2d(2, 4) with
    the images sharded P("data", "space"), and its inputs."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.RandomState(0)
    k1 = rng.randn(3, 3, 3, 8).astype(np.float32) * 0.1
    k2 = rng.randn(3, 3, 8, 4).astype(np.float32) * 0.1
    x = rng.randn(2, 16, 16, 3).astype(np.float32)

    def loss(ks, x):
        h = jax.lax.conv_general_dilated(x, ks[0], (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        h = jax.nn.relu(h)
        h = jax.lax.conv_general_dilated(h, ks[1], (2, 2), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.mean(h ** 2)

    mesh = make_mesh_2d(2, 4)
    ks = jax.device_put((jnp.asarray(k1), jnp.asarray(k2)), replicated(mesh))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", "space")))
    value, grads = jax.jit(jax.value_and_grad(loss))(ks, xs)
    return {"k1": k1, "k2": k2, "x": x, "loss": float(value),
            "grads": [np.asarray(g) for g in grads]}


@pytest.mark.watchdog(300)
@pytest.mark.parametrize("n_data,n_space", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_conv_core_matches_fdts_2x4_mesh(tmp_path, conv_core, n_data, n_space):
    outs = run_job(tmp_path, {"family": "convcore", "world": n_data * n_space,
                              "space": n_space},
                   {"k1": conv_core["k1"], "k2": conv_core["k2"]}, {"x": conv_core["x"]})
    for r, out in enumerate(outs):
        assert tuple(out["coords"]) == divmod(r, n_space)
        assert tuple(out["mesh_shape"]) == (n_data, n_space)
        np.testing.assert_allclose(out["loss"], conv_core["loss"], rtol=1e-5, atol=1e-6)
        for got, want in zip((out["g1"], out["g2"]), conv_core["grads"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the whole step ----------------------------------------------------------------

def space_batch():
    """The global batch at 64²: rows 0-1 one face each on darker noise, rows
    2-3 three faces each 40 levels brighter (float16-rounded, as the driver
    sends images), GT padded to 4 rows; faces in every band of the image."""
    rng = np.random.RandomState(2)
    images = rng.rand(BATCH, SIZE, SIZE, 3) * 200 - 117
    images[2:] += 40
    images = images.astype(np.float16).astype(np.float32)
    targets = []
    for i in range(BATCH):
        n = 1 if i < 2 else 3
        wh = 0.15 + rng.rand(n, 2) * 0.3
        xy = rng.rand(n, 2) * (1 - wh)
        targets.append(np.hstack([xy, xy + wh, np.zeros((n, 1))]).astype(np.float32))
    return (images,) + pad_targets(targets, max_gt=4)


def variables_of(variant: str) -> dict:
    """try3: fdt's load of net_weight/try3_mini.npz; try4 (no weight file):
    chip_smoke.seeded_variables nested into fdt's tree."""
    if variant == "try3":
        return load_variables(jax_build("try3"), str(ts.WEIGHTS), SIZE)
    seeded = chip_smoke.seeded_variables(build_pyramidbox(variant), chip_smoke.VARIANT_WEIGHTS_SEED)
    return nest_like(seeded, jax_build(variant), SIZE)


def fdt_space_steps(variant: str) -> dict:
    """fdt's PyramidTrainer step on make_mesh_2d(2, 2): the state replicated,
    the batch placed by train_batch_specs (images over data and height)."""
    variables = variables_of(variant)
    trainer = JaxTrainer(jax_build(variant), variant, input_size=SIZE, precision="highest")
    mesh = make_mesh_2d(2, 2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    state = jax.device_put(state, replicated(mesh))
    placed = shard_train_batch(mesh, space_batch())
    assert placed[0].sharding.spec == jax.sharding.PartitionSpec("data", "space")
    metrics = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, *placed, LR[variant])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"variables": variables, "metrics": metrics,
            "after": flat_variables({"params": jax.device_get(state.params),
                                     "batch_stats": jax.device_get(state.batch_stats)})}


def space_job(tmp_path, variant: str, variables: dict, world: int, n_space: int,
              **modes) -> list:
    """The port's STEPS steps on a (world / n_space) x n_space gloo mesh
    (`modes`: the worker's "remat", "bf16", "eval"): each rank's (metrics
    [STEPS, 5], variables after[, the eval loss before the steps])."""
    batch = dict(zip(("images", "gt_boxes", "gt_labels", "gt_valid"), space_batch()))
    tmp_path.mkdir(parents=True, exist_ok=True)
    outs = run_job(tmp_path, {"family": "pyramid", "world": world, "space": n_space,
                              "variant": variant, "size": SIZE, "steps": STEPS,
                              "lr": LR[variant], **modes}, flat_variables(variables), batch)
    return [(o["metrics"], {k[2:]: o[k] for k in o if k.startswith("v/")})
            + ((float(o["eval"]),) if "eval" in o else ()) for o in outs]


def check_ranks_bit_equal(outs: list) -> None:
    m0, v0 = outs[0][:2]
    for m, v, *_ in outs[1:]:
        np.testing.assert_array_equal(m, m0)
        assert v.keys() == v0.keys()
        for k in v0:
            np.testing.assert_array_equal(v[k], v0[k], err_msg=k)


def check_against(metrics, variables, want_metrics, want_after, before) -> None:
    """The data-parallel tests' tolerances (tests/test_torch_train_step.py)."""
    for step in range(STEPS):
        for j, k in enumerate(ts.PARTS):
            np.testing.assert_allclose(metrics[step, j], want_metrics[step][k],
                                       rtol=ts.LOSS_RTOL[step], err_msg=f"step {step + 1} {k}")
    ts.check_variables(variables, want_after, before)


@pytest.fixture(scope="module")
def fdt_try3():
    return fdt_space_steps("try3")


@pytest.fixture(scope="module")
def fdt_try4():
    return fdt_space_steps("try4")


@pytest.mark.watchdog(600)
@pytest.mark.parametrize("variant", [
    "try3", pytest.param("try4", marks=pytest.mark.slow)])
def test_2x2_step_matches_fdts_step_on_make_mesh_2d(tmp_path, request, variant):
    fdt = request.getfixturevalue(f"fdt_{variant}")
    outs = space_job(tmp_path, variant, fdt["variables"], 4, 2)
    check_ranks_bit_equal(outs)
    check_against(*outs[0], fdt["metrics"], fdt["after"], flat_variables(fdt["variables"]))


@pytest.mark.slow
@pytest.mark.watchdog(600)
@pytest.mark.parametrize("variant", ["try3", "try4"])
def test_space_only_1x2_step_matches_the_one_device_step(tmp_path, variant):
    """Two bands of one batch: the port's one-device step on the same
    variables and batch, within the same tolerances, and the eval loss
    before it within step 1's."""
    variables = variables_of(variant)
    outs = space_job(tmp_path, variant, variables, 2, 2, eval=True)
    check_ranks_bit_equal(outs)
    assert outs[0][2] == outs[1][2]
    one = ts.port_trainer(variables, variant, size=SIZE)
    np.testing.assert_allclose(outs[0][2], float(one.eval_loss(*space_batch())),
                               rtol=ts.LOSS_RTOL[0])
    metrics = [[float(v) for v in one.train_step(*space_batch(), LR[variant]).values()]
               for _ in range(STEPS)]
    after = flat_variables(to_jax_variables(one.model))
    check_against(outs[0][0], outs[0][1], [dict(zip(ts.PARTS, m)) for m in metrics], after,
                  flat_variables(variables))


@pytest.mark.slow
@pytest.mark.watchdog(600)
def test_remat_and_bf16_run_on_the_2x2_mesh(tmp_path):
    """remat's recompute re-issues every exchange in the backward: its steps
    equal the plain 2 x 2 steps bit for bit.  bf16 (autocast) exchanges its
    bands in bf16: the ranks end bit-equal and its step-1 loss is the
    float32 one's within bf16's rounding (2e-2)."""
    variables = variables_of("try3")
    plain = space_job(tmp_path / "plain", "try3", variables, 4, 2)
    remat = space_job(tmp_path / "remat", "try3", variables, 4, 2, remat=True)
    check_ranks_bit_equal(remat)
    np.testing.assert_array_equal(remat[0][0], plain[0][0])
    for k in plain[0][1]:
        np.testing.assert_array_equal(remat[0][1][k], plain[0][1][k], err_msg=k)
    bf16 = space_job(tmp_path / "bf16", "try3", variables, 4, 2, bf16=True)
    check_ranks_bit_equal(bf16)
    assert np.isfinite(bf16[0][0]).all()
    np.testing.assert_allclose(bf16[0][0][0], plain[0][0][0], rtol=2e-2)


# -- the CLI -------------------------------------------------------------------------

@pytest.mark.watchdog(900)
def test_dp_and_sp_devices_cli_trains_and_saves_a_readable_checkpoint(tmp_path, mini_train,
                                                                       capfd):
    """--dp_devices 2 --sp_devices 2 --device cpu: four local ranks over gloo
    (two data indices, each image's rows in two bands) take 2 steps; rank 0
    writes the checkpoint and the loss file, and the port's loader reads the
    checkpoint back into the variant."""
    args = ["--net", "try3", "--input_size", "128", "--batch_size", "2", "--iter", "2",
            "--save_point", "2", "--lr", "1e-4", "--annoPath", mini_train,
            "--save_folder", str(tmp_path) + "/", "--device", "cpu",
            "--dp_devices", "2", "--sp_devices", "2"]
    assert train_pyramid.main(args) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[train] ")]
    assert len(lines) == 1  # rank 0 reports
    info = json.loads(lines[0][len("[train] "):])
    assert (info["ranks"], info["global_batch"], info["step"]) == (4, 2, 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["try3_pyramid_2",
                                                          "try3_pyramid_loss_2.npy"]
    loss = np.load(tmp_path / "try3_pyramid_loss_2.npy")
    assert np.isfinite(loss[0, :2]).all() and loss[0, :2].min() > 0
    model = load_model_weights(str(tmp_path / "try3_pyramid_2"), build_pyramidbox("try3"))
    assert all(torch.isfinite(t).all() for t in model.state_dict().values()
               if t.is_floating_point())
