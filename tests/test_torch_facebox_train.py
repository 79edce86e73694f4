"""fdt_torch's FaceBoxes training (facebox_encode, FaceBoxTrainer, its
checkpoints and the train_facebox CLI) against fdt's
(fdt/anchors/densified.py, fdt/train/facebox_train.py).

The encoder runs on the full 1024² grid of 21,824 default boxes.  The steps
run at 128² with maps 4/2/1 (341 default boxes; fdt's own test shrinks the
grid the same way), batch 2, float32 precision "highest", from
chip_smoke.seeded_variables on both sides, at lr 1e-3: 3 steps whose loss
falls from 12.33 to 10.13.

Tolerances, with what they measured:
  * facebox_encode: conf exactly equal, loc within 1e-6 (measured 9.5e-7,
    one float32 ulp of a value near 10: the two libraries' log);
  * the loss parts within 2e-5 relative at every step (measured 4.1e-6);
  * each parameter's change within 1e-3 of the largest change of any leaf
    (measured 6.5e-5), the running statistics within 1e-3 of each leaf's
    largest value (measured 3.4e-5).
"""
import dataclasses
import io
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.anchors.densified import facebox_encode as jax_encode  # noqa: E402
from fdt.config import FACEBOX as JAX_FACEBOX  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.train.facebox_train import FaceBoxTrainer as JaxTrainer  # noqa: E402
from fdt.train.loops import TrainState  # noqa: E402
from fdt_torch.anchors.densified import facebox_default_boxes, facebox_encode  # noqa: E402
from fdt_torch.config import FACEBOX  # noqa: E402
from fdt_torch.models import FaceBox, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, to_jax_variables  # noqa: E402
from fdt_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from fdt_torch.train.facebox_train import FaceBoxTrainer  # noqa: E402
from fdt_torch.train.loops import pad_targets  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(input_size=128, feature_map_sizes=(4, 2, 1))
SIZE, BATCH, STEPS, LR = 128, 2, 3, 1e-3
LOSS_RTOL = 2e-5
CHANGE_RTOL = 1e-3   # of the largest change of any leaf
STATS_RTOL = 1e-3    # of the leaf's largest value
PARTS = ("loss", "loc", "conf")


def make_batch(seed: int = 0, size: int = SIZE, b: int = BATCH):
    """Raw 0-255 images and 1-2 faces an image (label 1), padded to 4 rows."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.float32)
    targets = []
    for i in range(b):
        n = 1 + i % 2
        wh = 0.1 + rng.rand(n, 2) * 0.4
        xy = rng.rand(n, 2) * (1 - wh)
        targets.append(np.hstack([xy, xy + wh, np.ones((n, 1))]).astype(np.float32))
    gt_boxes, _, gt_valid = pad_targets(targets, max_gt=4)
    return images, gt_boxes, gt_valid.astype(np.int32), gt_valid


def encode_case(name: str):
    """(gt_boxes [B,G,4], labels [B,G], valid [B,G]) of an encoder case."""
    rng = np.random.RandomState(len(name))
    g = 6
    boxes = np.zeros((3, g, 4), np.float32)
    valid = np.zeros((3, g), bool)
    if name == "conflict":
        # rows 0 and 2 differ slightly but claim the same default box: the
        # last (row 2) wins; row 1 elsewhere; rows 3-5 padding
        boxes[:, 0] = [0.30, 0.30, 0.36, 0.36]
        boxes[:, 1] = [0.60, 0.55, 0.80, 0.75]
        boxes[:, 2] = [0.30, 0.30, 0.362, 0.36]
        valid[:, :3] = True
    elif name == "padded":
        for i in range(3):
            n = 1 + i
            wh = 0.02 + rng.rand(n, 2) * 0.4
            xy = rng.rand(n, 2) * (1 - wh)
            boxes[i, :n] = np.hstack([xy, xy + wh])
            valid[i, :n] = True
        boxes[:, 5] = [0.1, 0.1, 0.5, 0.5]  # an invalid row with a box in it
    elif name == "no-valid-gt":
        boxes[0, :2] = [[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]  # never valid
        wh = 0.05 + rng.rand(g, 2) * 0.3
        xy = rng.rand(g, 2) * (1 - wh)
        boxes[1] = np.hstack([xy, xy + wh])
        valid[1] = True
    else:  # "random": many GT, some tiny, on every image
        wh = 0.005 + rng.rand(3, g, 2) * 0.5
        xy = rng.rand(3, g, 2) * (1 - wh)
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        valid = rng.rand(3, g) < 0.8
    labels = valid.astype(np.int32)
    return boxes, labels, valid


@pytest.mark.parametrize("name", ["conflict", "padded", "no-valid-gt", "random"])
def test_facebox_encode_equals_fdt_on_the_full_grid(name):
    """Conf exactly, loc within 1e-6, on the 21,824 default boxes of the
    1024² config, each image against fdt's encoder."""
    boxes, labels, valid = encode_case(name)
    defaults = np.array(facebox_default_boxes(FACEBOX))
    assert defaults.shape == (21824, 4)
    loc, conf = facebox_encode(torch.from_numpy(boxes), torch.from_numpy(labels),
                               torch.from_numpy(valid), torch.from_numpy(defaults),
                               FACEBOX.match_thresh)
    assert loc.shape == (3, 21824, 4) and conf.shape == (3, 21824)
    for i in range(3):
        want_loc, want_conf = jax_encode(jnp.asarray(boxes[i]), jnp.asarray(labels[i]),
                                         jnp.asarray(valid[i]), defaults,
                                         JAX_FACEBOX.match_thresh)
        np.testing.assert_array_equal(conf[i].numpy(), np.asarray(want_conf))
        np.testing.assert_allclose(loc[i].numpy(), np.asarray(want_loc), rtol=0, atol=1e-6)
        assert np.isfinite(loc[i].numpy()).all()
    if name == "conflict":
        from fdt_torch.geometry.boxes import iou_matrix, point_form
        ious = iou_matrix(torch.from_numpy(boxes[0]), point_form(torch.from_numpy(defaults)))
        best = ious.argmax(dim=1)
        assert best[0] == best[2]  # the two rows claim one box
        p = int(best[0])
        want = facebox_encode(torch.from_numpy(boxes[:1, 2:3]), torch.ones(1, 1, dtype=torch.int32),
                              torch.ones(1, 1, dtype=torch.bool), torch.from_numpy(defaults))[0]
        torch.testing.assert_close(loc[0, p], want[0, p], rtol=0, atol=0)  # row 2 won
        assert int(conf[0, p]) == 1
    if name == "no-valid-gt":
        assert int(conf[0].sum()) == 0 and int(conf[2].sum()) == 0 and int(conf[1].sum()) > 0


@pytest.fixture(scope="module")
def seeded():
    return chip_smoke.seeded_variables(FaceBox(), chip_smoke.FACEBOX_WEIGHTS_SEED)


@pytest.fixture(scope="module")
def fdt_run(seeded):
    """fdt's FaceBoxTrainer at 128² from the seeded variables: the metrics
    and variables after each step."""
    variables = nest_like(seeded, JaxFaceBox(), SIZE)
    trainer = JaxTrainer(cfg=dataclasses.replace(JAX_FACEBOX, **SMALL), precision="highest")
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=trainer.tx.init(params))
    out = {"before": flat_variables(variables), "metrics": [], "after": []}
    for _ in range(STEPS):
        state, m = trainer.train_step(state, *make_batch(), LR)
        out["metrics"].append({k: float(m[k]) for k in PARTS})
        out["after"].append(flat_variables({"params": jax.device_get(state.params),
                                            "batch_stats": jax.device_get(state.batch_stats)}))
    return out


def port_trainer(seeded, **kw):
    model = FaceBox()
    model.load_state_dict(from_jax_variables(seeded), strict=True)
    return FaceBoxTrainer(model, cfg=dataclasses.replace(FACEBOX, **SMALL), precision="highest",
                          device="cpu", **kw)


def check_variables(got: dict, want: dict, before: dict):
    assert got.keys() == want.keys()
    scale = max(np.abs(want[k] - before[k]).max() for k in want if k.startswith("params/"))
    for key in want:
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key] - before[key], want[key] - before[key],
                                       rtol=0, atol=CHANGE_RTOL * scale, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=STATS_RTOL * np.abs(want[key]).max(), err_msg=key)


def test_train_steps_match_fdt(fdt_run, seeded):
    """Loss parts at every step, then params and batch_stats after each."""
    trainer = port_trainer(seeded)
    assert trainer.step == 0 and trainer.model.training
    for step in range(STEPS):
        m = trainer.train_step(*make_batch(), LR)
        assert set(m) == set(PARTS) and all(v.dim() == 0 for v in m.values())
        for k in PARTS:
            np.testing.assert_allclose(float(m[k]), fdt_run["metrics"][step][k],
                                       rtol=LOSS_RTOL, err_msg=f"step {step + 1} {k}")
        check_variables(flat_variables(to_jax_variables(trainer.model)),
                        fdt_run["after"][step], fdt_run["before"])
    assert trainer.step == STEPS
    losses = [m["loss"] for m in fdt_run["metrics"]]
    assert losses[-1] < losses[0]


def test_trainer_targets_are_fdts_vmapped_encoder():
    """The trainer's targets for a padded batch are fdt's encoder image by
    image (its vmap), on the small grid."""
    _, gt_boxes, gt_labels, gt_valid = make_batch(3, b=3)
    cfg = dataclasses.replace(FACEBOX, **SMALL)
    defaults = np.array(facebox_default_boxes(cfg))
    loc, conf = facebox_encode(torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels),
                               torch.from_numpy(gt_valid), torch.from_numpy(defaults),
                               cfg.match_thresh)
    want_loc, want_conf = jax.vmap(lambda b, l, v: jax_encode(b, l, v, defaults, 0.35))(
        gt_boxes, gt_labels, gt_valid)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(want_conf))
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), rtol=0, atol=1e-6)


def test_checkpoint_loads_into_fdt_and_back(seeded, tmp_path):
    """A checkpoint the port writes after a step is fdt's layout: fdt's
    load_variables reads it bit-equal to the port's variables; fdt's own
    npz loads into the port bit-equal; a restored trainer steps exactly as
    the one it was saved from."""
    from fdt.models.loader import save_variables_npz as jax_save_npz
    from fdt_torch.train.checkpoint import load_weights
    trainer = port_trainer(seeded)
    trainer.train_step(*make_batch(), LR)
    path = save_checkpoint(trainer, str(tmp_path), "facebox", 1)
    assert path.endswith("facebox_1")
    theirs = flat_variables(load_variables(JaxFaceBox(), f"{path}/variables.npz", SIZE))
    ours = flat_variables(to_jax_variables(trainer.model))
    assert theirs.keys() == ours.keys()
    for k in ours:
        np.testing.assert_array_equal(theirs[k], ours[k], err_msg=k)
    # fdt → port: fdt writes the seeded variables (float32), the port reads them
    variables = nest_like(seeded, JaxFaceBox(), SIZE)
    jax_save_npz(variables, str(tmp_path / "fdt.npz"), dtype=np.float32)
    fresh = port_trainer(chip_smoke.seeded_variables(FaceBox(), 5))
    load_weights(str(tmp_path / "fdt.npz"), fresh)
    got = flat_variables(to_jax_variables(fresh.model))
    for k, v in flat_variables(variables).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # resume: the restored trainer's next step is the saved one's
    resumed = restore_checkpoint(path, port_trainer(chip_smoke.seeded_variables(FaceBox(), 5)))
    assert resumed.step == 1
    a = trainer.train_step(*make_batch(1), LR)
    b = resumed.train_step(*make_batch(1), LR)
    for k in PARTS:
        assert float(a[k]) == float(b[k]), k
    for k, v in flat_variables(to_jax_variables(trainer.model)).items():
        np.testing.assert_array_equal(flat_variables(to_jax_variables(resumed.model))[k], v)


def test_trainer_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FaceBoxTrainer(FaceBox())


def test_cli_help_and_refusal(monkeypatch, capsys):
    from fdt_torch.cli import train_facebox
    with pytest.raises(SystemExit) as e:
        train_facebox.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--batch_size", "--lr", "--momentum", "--weight_decay", "--iter",
                 "--save_point", "--resume", "--annoPath", "--save_folder", "--device"):
        assert flag in out
    args = train_facebox.build_parser().parse_args([])
    assert (args.batch_size, args.lr, args.momentum, args.weight_decay, args.iter,
            args.save_point, args.device) == (16, 1e-3, 0.9, 5e-4, 120000, 3000, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_facebox.main(["--annoPath", "nowhere.txt"])


def test_cli_trains_saves_and_resumes_on_the_cpu(monkeypatch, tmp_path):
    """python -m fdt_torch.cli.train_facebox --device cpu over seeded image
    files (the grid shrunk to 128², batch 2: at batch 1 the 1×1 last maps
    leave BatchNorm one value a channel): 2 iterations with a checkpoint at
    each, then --resume from facebox_2 to iteration 3."""
    import fdt_torch.config as config
    from fdt_torch.cli import train_facebox
    monkeypatch.setattr(config, "FACEBOX", dataclasses.replace(FACEBOX, **SMALL))
    anno = chip_smoke.write_train_set(tmp_path, n=2)
    argv = ["--batch_size", "2", "--save_point", "1", "--annoPath", str(anno),
            "--save_folder", str(tmp_path / "out"), "--device", "cpu"]
    assert train_facebox.main(argv + ["--iter", "2"]) == 0
    assert {p.name for p in (tmp_path / "out").iterdir()} == {"facebox_1", "facebox_2"}
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert train_facebox.main(argv + ["--iter", "3", "--resume"]) == 0
    assert f"resumed from {tmp_path / 'out' / 'facebox_2'}" in buf.getvalue()
    with np.load(tmp_path / "out" / "facebox_3" / "opt_state.npz") as z:
        assert int(z["step"]) == 3
        assert any(k.startswith("momentum/") for k in z.files)
    v = load_variables(JaxFaceBox(), str(tmp_path / "out" / "facebox_3" / "variables.npz"), SIZE)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(v))
