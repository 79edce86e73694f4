"""fdt_torch's net2net distillation (the models' feature taps, the
trainer's loss and teacher, its checkpoints and the train_net2net CLI)
against fdt's (fdt/models/pyramidbox*.py return_features,
fdt/train/net2net.py); each mode's steps are in
tests/test_torch_net2net_steps.py.

The taps of PyramidBox-ResNet50 and try1-try5 are held to fdt's
return_features=True outputs at 128² on the repo's npz weights (repo,
try1, try3) or seeded ones (try2, try4, try5), within FORWARD_TOL of each
tensor's largest value (the port's forward tolerance; measured 2.9e-6
(try3) to 8.0e-5 (try2)).

The flagship teacher at 640² (repo → try1, fdt's configuration) is in the
slow test and in tests/test_torch_net2net_golden.py.
"""
import io
import pathlib
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.models.loader import load_variables  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt_torch.models import build_pyramidbox, from_jax_variables  # noqa: E402
from fdt_torch.models.loader import flat_variables, load_npz, to_jax_variables  # noqa: E402
from fdt_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from fdt_torch.train.net2net import (INTERMEDIA_WEIGHTS, OVERALL_WEIGHTS,  # noqa: E402
                                     SOURCE_WEIGHT, Net2NetTrainer)
from tests.test_torch_net2net_steps import SIZE, make_images, port_trainer  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

NPZ = {"repo": "net_weight/repo_mini.npz", "try1": "net_weight/try1_distilled_mini.npz",
       "try3": "net_weight/try3_mini.npz"}
TAP_SIZE, FORWARD_TOL = 128, 2e-4
LR = 1e-7


def flat_weights(variant: str) -> dict:
    if variant in NPZ:
        return load_npz(str(REPO / NPZ[variant]))
    return chip_smoke.seeded_variables(build_pyramidbox(variant), 0)


def fdt_tree(variant: str, size: int) -> dict:
    if variant in NPZ:
        return load_variables(jax_build(variant), str(REPO / NPZ[variant]), size)
    return nest_like(flat_weights(variant), jax_build(variant), size)


def port_model(variant: str, flat: dict | None = None):
    model = build_pyramidbox(variant)
    model.load_state_dict(from_jax_variables(flat if flat is not None else flat_weights(variant)),
                          strict=True)
    return model


@pytest.mark.parametrize("variant", ["repo", "try1", "try2", "try3", "try4", "try5"])
def test_feature_taps_match_fdt(variant):
    """features (repo, try1, try2: c2..c7; try3-try5: c2..c6, as fdt taps
    them) and the source maps, NCHW, against fdt's NHWC taps; an eval-mode
    forward on a seeded 128² batch."""
    x = np.random.RandomState(3).randn(2, TAP_SIZE, TAP_SIZE, 3).astype(np.float32) * 50
    want = jax_build(variant, return_features=True).apply(fdt_tree(variant, TAP_SIZE),
                                                           jnp.asarray(x))
    model = port_model(variant).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), features=True)
    n_feat = 6 if variant in ("repo", "try1", "try2") else 5
    assert len(got["features"]) == len(want["features"]) == n_feat
    assert len(got["sources"]) == len(want["sources"])
    for name in ("features", "sources"):
        for i, (a, b) in enumerate(zip(got[name], want[name])):
            b = np.asarray(b).transpose(0, 3, 1, 2)
            assert tuple(a.shape) == b.shape, (name, i)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=FORWARD_TOL * np.abs(b).max(), err_msg=f"{name} {i}")
    assert "head_loc" not in got  # the taps do not ask for the head branch


@pytest.mark.parametrize("variant", ["repo", "try3"])
def test_features_false_returns_the_detect_dict_exactly(variant):
    """features=False (the default, the detect path) returns exactly the dict
    it returned before the taps, bit-equal to the same forward with taps."""
    model = port_model(variant).eval()
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 96, 96).astype(np.float32))
    with torch.no_grad():
        plain, default, tapped = model(x), model(x, heads=False, features=False), model(
            x, features=True)
    assert set(plain) == {"face_loc", "face_conf", "source_shapes"}
    assert set(tapped) == set(plain) | {"features", "sources"}
    for k in ("face_loc", "face_conf"):
        torch.testing.assert_close(plain[k], default[k], rtol=0, atol=0)
        torch.testing.assert_close(plain[k], tapped[k], rtol=0, atol=0)
    assert plain["source_shapes"] == tapped["source_shapes"] == tuple(
        (s.shape[3], s.shape[2]) for s in tapped["sources"])


def test_loss_is_the_weighted_sum_of_fdts_parts():
    weights = {"intermedia": INTERMEDIA_WEIGHTS, "source": (SOURCE_WEIGHT,) * 6,
               "overall": OVERALL_WEIGHTS}
    assert weights["intermedia"] == (12.0, 12.0, 12.0, 12.0, 8.0, 8.0)
    assert SOURCE_WEIGHT == 128.0 and OVERALL_WEIGHTS == (4.0, 1.0, 4.0, 1.0)
    from fdt.train import net2net as jax_n2n
    assert (jax_n2n.INTERMEDIA_WEIGHTS, jax_n2n.SOURCE_WEIGHT, jax_n2n.OVERALL_WEIGHTS) == (
        INTERMEDIA_WEIGHTS, SOURCE_WEIGHT, OVERALL_WEIGHTS)
    trainer = port_trainer("source")
    m = trainer.train_step(make_images(), 0.0)
    np.testing.assert_allclose(float(m["loss"]), float(m["parts"].sum()) * SOURCE_WEIGHT,
                               rtol=1e-6)


def test_unknown_mode_and_no_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown net2net mode"):
        port_trainer("heads")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Net2NetTrainer(build_pyramidbox("try1"), build_pyramidbox("try1"))


def test_checkpoint_loads_into_fdt_and_resumes(tmp_path):
    """The student's checkpoint loads into fdt's load_variables bit-equal, and
    a restored trainer (momentum and step) steps as the saved one does."""
    trainer = port_trainer("overall")
    trainer.train_step(make_images(size=128), LR)
    path = save_checkpoint(trainer, str(tmp_path), "overall_net", 1)
    theirs = flat_variables(load_variables(jax_build("try1"), f"{path}/variables.npz", SIZE))
    ours = flat_variables(to_jax_variables(trainer.model))
    assert theirs.keys() == ours.keys()
    for k in ours:
        np.testing.assert_array_equal(theirs[k], ours[k], err_msg=k)
    resumed = restore_checkpoint(path, port_trainer("overall"))
    assert resumed.step == 1
    a, b = (t.train_step(make_images(1, size=128), LR) for t in (trainer, resumed))
    torch.testing.assert_close(a["parts"], b["parts"], rtol=0, atol=0)


def test_cli_help_defaults_and_refusals(monkeypatch, capsys, tmp_path):
    from fdt_torch.cli import train_net2net
    with pytest.raises(SystemExit) as e:
        train_net2net.main(["--help"])
    assert e.value.code == 0
    args = train_net2net.build_parser().parse_args([])
    assert (args.train, args.student, args.batch_size, args.lr, args.iter, args.save_point,
            args.start_iter, args.momentum, args.teacher_weights) == (
        "intermedia", "try1", 8, 1e-3, 500000, 2000, 0, 0.5, "net_weight/repo_mini.npz")
    with pytest.raises(SystemExit):
        train_net2net.build_parser().parse_args(["--student", "try3"])
    # a .pth teacher is read (fdt's default file is absent: torch.load's error)
    with pytest.raises(FileNotFoundError, match="Res50_pyramid.pth"):
        train_net2net.main(["--teacher_weights", "./net_weight/Res50_pyramid.pth",
                            "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_net2net.main(["--teacher_weights", str(REPO / NPZ["repo"])])


def test_cli_runs_saves_and_chains_on_the_cpu(monkeypatch, tmp_path):
    """python -m fdt_torch.cli.train_net2net --device cpu over seeded image
    files at 128²: 3 iterations (a checkpoint and the loss file at 2, the
    final checkpoint at 3), then a chained run from intermedia_net_2
    (--start_iter 2 --resume) to iteration 4."""
    from fdt_torch.cli import train_net2net
    monkeypatch.setattr(train_net2net, "INPUT_SIZE", 128)
    anno = chip_smoke.write_train_set(tmp_path, n=2)
    out = tmp_path / "out"
    argv = ["--batch_size", "2", "--save_point", "2", "--annoPath", str(anno),
            "--save_folder", str(out), "--teacher_weights", str(REPO / NPZ["repo"]),
            "--device", "cpu"]
    with redirect_stdout(io.StringIO()):
        assert train_net2net.main(argv + ["--iter", "3"]) == 0
    assert {p.name for p in out.iterdir()} == {"intermedia_net_2", "intermedia_loss_2.npy",
                                               "intermedia_net_final_3"}
    losses = np.load(out / "intermedia_loss_2.npy")
    assert losses.shape == (3,) and (losses[:2] > 0).all() and losses[2] == 0
    with redirect_stdout(io.StringIO()):
        assert train_net2net.main(argv + ["--iter", "4", "--start_iter", "2",
                                          "--resume", str(out / "intermedia_net_2")]) == 0
    with np.load(out / "intermedia_net_4" / "opt_state.npz") as z:
        assert int(z["step"]) == 4


@pytest.mark.slow
def test_flagship_teacher_step_matches_fdt_at_640():
    """fdt's configuration, repo → try1 at 640², one intermedia step from
    the repo's npz files: the loss parts within 1e-4."""
    from tests.test_torch_net2net_golden import make_golden, port_trainer as golden_trainer
    g = make_golden(modes=("intermedia",))
    batch = chip_smoke.net2net_batch(int(g["seed"]), int(g["batch"]))
    m = golden_trainer("intermedia").train_step(*batch, float(g["intermedia/lr"]))
    got = np.concatenate([[float(m["loss"])], m["parts"].numpy()])
    np.testing.assert_allclose(got, g["intermedia/losses"][0], rtol=1e-4)
