"""fdt_torch's training driver, checkpoints, CLI and watchdog (counterparts
of fdt/train/driver.py, fdt/train/checkpoint.py, scripts/train_pyramid.py
and fdt/utils/watchdog.py), on a tiny dataset of PNG and JPEG files the
test writes itself, try3 at 128² on the CPU.

Cross-loading: fdt's load_variables reads the port's checkpoint variables
(float32, bit-equal), and the port trains from an npz fdt wrote.
"""
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt.models.loader import load_variables as fdt_load_variables  # noqa: E402
from fdt.models.loader import save_variables_npz as fdt_save_npz  # noqa: E402
from fdt_torch.cli import train_pyramid  # noqa: E402
from fdt_torch.models import build_pyramidbox  # noqa: E402
from fdt_torch.models.loader import (flat_variables, save_variables_npz,  # noqa: E402
                                     to_jax_variables)
from fdt_torch.train.checkpoint import (OPT_STATE, VARIABLES, latest_checkpoint,  # noqa: E402
                                        restore_checkpoint, save_checkpoint)
from fdt_torch.train.driver import (TrainConfig, prefetch_batches,  # noqa: E402
                                    run_pyramid_training)
from fdt_torch.train.loops import LossHistory, PyramidTrainer, xavier_init  # noqa: E402
from fdt_torch.utils.watchdog import STALL_EXIT_CODE, StallWatchdog  # noqa: E402
from tests.test_torch_augment import photo  # noqa: E402
from tests.test_torch_train_step import make_batch  # noqa: E402

torch.set_num_threads(1)

SIZE = 128


def write_dataset(directory: pathlib.Path, n: int = 4) -> pathlib.Path:
    """n seeded photo-like images, PNG and JPEG in turns, two faces each."""
    from PIL import Image
    lines = []
    for i in range(n):
        img = photo(150 + 10 * i, 200, i)
        path = directory / f"im_{i}.{'jpg' if i % 2 else 'png'}"
        Image.fromarray(img[:, :, ::-1]).save(path)
        lines.append(f"{path} 2 40 30 40 60 110 50 30 34")
    anno = directory / "anno.txt"
    anno.write_text("\n".join(lines) + "\n")
    return anno


def trainer(seed: int = 0, **kw) -> PyramidTrainer:
    return PyramidTrainer(xavier_init(build_pyramidbox("try3"), seed), "try3", input_size=SIZE,
                          device="cpu", **kw)


def test_training_loop_writes_history_eval_losses_and_checkpoints(tmp_path):
    anno = write_dataset(tmp_path)
    t = trainer()
    logs = []
    cfg = TrainConfig(batch_size=2, total_iters=4, save_point=2, max_gt=4,
                      save_folder=str(tmp_path), name="tiny", eval_freq=2, eval_batches=1,
                      step_values=(3,), lr=1e-3, stall_timeout=60.0)
    stats = {}
    run_pyramid_training(t, str(anno), cfg, val_anno=str(anno), log=logs.append, stats=stats)
    assert t.step == 4 and stats["iterations"] == 4 and stats["wall_s"] > 0
    for it in (2, 4):
        loss = np.load(tmp_path / f"tiny_loss_{it}.npy")
        assert loss.shape == (5, 3)                     # the reference's 5-row layout
        assert np.isfinite(loss[:, :2]).all() and (loss[0, :2] > 0).all()
        np.testing.assert_allclose(loss[0, :2], loss[1, :2] + loss[2, :2]
                                   + 0.5 * (loss[3, :2] + loss[4, :2]), rtol=1e-5)
        assert not loss[:, 2].any()
        assert (tmp_path / f"tiny_{it}" / VARIABLES).exists()
    # eval at iteration 1 and 2, then at 4; eval_batches + 1 = 2 batches each
    assert len(np.load(tmp_path / "tiny_eval_loss_2.npy")) == 2
    assert len(np.load(tmp_path / "tiny_eval_loss_4.npy")) == 1
    # the lr schedule: iteration 3 is a step value, lr × gamma
    assert "adjusting lr to 0.0005" in logs
    assert t.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert latest_checkpoint(str(tmp_path), "tiny") == str(tmp_path / "tiny_4")


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """A restored trainer holds the saved params, batch_stats, momentum and
    step, and its next step equals the original trainer's, bit for bit."""
    batch = make_batch(2)
    a = trainer()
    for _ in range(2):
        a.train_step(*batch, 1e-3)
    path = save_checkpoint(a, str(tmp_path), "try3_pyramid", 2)
    with np.load(pathlib.Path(path) / OPT_STATE) as z:
        assert int(z["step"]) == 2 and sum(k.startswith("momentum/") for k in z.files) > 100
    b = restore_checkpoint(path, trainer(seed=1))
    assert b.step == 2
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        if "num_batches" not in k:
            assert torch.equal(x, y), k
    ma, mb = a.train_step(*batch, 1e-3), b.train_step(*batch, 1e-3)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, x), (_, y) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(x, y), k


def test_fdt_reads_the_port_checkpoint_and_the_port_trains_from_fdt_npz(tmp_path):
    """fdt's load_variables reads the port's checkpoint variables.npz
    (float32: equal to the port's weights) and its save_variables_npz
    default (float16 params, compressed, as fdt writes); the CLI resumes
    from an npz fdt wrote and trains."""
    t = trainer()
    t.train_step(*make_batch(3), 1e-3)
    path = save_checkpoint(t, str(tmp_path), "x", 1)
    theirs = flat_variables(fdt_load_variables(None, str(pathlib.Path(path) / VARIABLES), SIZE))
    ours = flat_variables(to_jax_variables(t.model))
    assert theirs.keys() == ours.keys()
    for k in ours:
        np.testing.assert_array_equal(theirs[k], ours[k], err_msg=k)
    save_variables_npz(to_jax_variables(t.model), str(tmp_path / "f16.npz"))  # fdt's default
    f16 = flat_variables(fdt_load_variables(None, str(tmp_path / "f16.npz"), SIZE))
    for k in ours:  # params stored float16, batch_stats float32
        np.testing.assert_allclose(f16[k], ours[k], rtol=1e-3 if k.startswith("params/") else 0,
                                   atol=1e-4 if k.startswith("params/") else 0, err_msg=k)

    npz = tmp_path / "fdt_written.npz"
    fdt_save_npz(fdt_load_variables(None, str(REPO / "net_weight" / "try3_mini.npz"), SIZE),
                 str(npz))
    anno = write_dataset(tmp_path, 2)
    out = tmp_path / "run"
    train_pyramid.main(["--net", "try3", "--input_size", str(SIZE), "--batch_size", "2",
                        "--iter", "2", "--save_point", "2", "--max_gt", "4", "--device", "cpu",
                        "--annoPath", str(anno), "--save_folder", str(out),
                        "--resume", str(npz)])
    assert (out / "try3_pyramid_2" / VARIABLES).exists()


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """--resume of a checkpoint directory with --start_iter: the step goes
    on from the saved one."""
    anno = write_dataset(tmp_path, 2)
    args = ["--net", "try3", "--input_size", str(SIZE), "--batch_size", "2", "--max_gt", "4",
            "--device", "cpu", "--annoPath", str(anno), "--save_folder", str(tmp_path),
            "--save_point", "2", "--train_pretrain", "2"]
    train_pyramid.main(args + ["--iter", "2"])
    train_pyramid.main(args + ["--iter", "4", "--start_iter", "2",
                               "--resume", str(tmp_path / "try3_pyramid_2")])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train] ")]
    last = json.loads(lines[-1][len("[train] "):])
    assert last["iterations"] == 2 and last["step"] == 4
    with np.load(tmp_path / "try3_pyramid_4" / OPT_STATE) as z:
        assert int(z["step"]) == 4


@pytest.mark.parametrize("flag,message", [
    (["--dp_devices", "2", "--batch_size", "7"], "does not divide over --dp_devices 2"),
    (["--sp_devices", "2"], "data x space mesh.*next slice.*Queue 1 item 5"),
    (["--num_processes", "2"], "requires --max_gt")], ids=["flag0", "flag1", "flag2"])
def test_cli_refuses_what_this_slice_does_not_bring(flag, message):
    """The data x space mesh is the next slice; --dp_devices and
    --num_processes take fdt's rules (a batch that divides over the ranks,
    --max_gt across processes; tests/test_torch_dist.py runs them)."""
    with pytest.raises(SystemExit, match=message):
        train_pyramid.main(flag)


def test_cli_defaults_are_fdt_scripts():
    import importlib.util
    spec = importlib.util.spec_from_file_location("fdt_train_cli",
                                                  REPO / "scripts" / "train_pyramid.py")
    src = spec.loader.get_source("fdt_train_cli")
    ours = train_pyramid.build_parser()
    for action in ours._actions:
        if action.dest in ("help", "device"):
            continue
        assert f'"--{action.dest}"' in src, action.dest
    defaults = vars(ours.parse_args([]))
    assert (defaults["net"], defaults["batch_size"], defaults["lr"], defaults["momentum"],
            defaults["iter"], defaults["save_point"]) == ("repo", 7, 2e-5, 0.6, 120000, 3000)
    assert defaults["device"] is None  # the card


def test_mesh_is_refused(tmp_path):
    """A mesh of several devices in one process is not a training mesh: the
    port trains one process a device, started by the CLI (fdt's
    single-process mesh has no counterpart; ROADMAP Queue 3)."""
    from fdt_torch.dist import make_mesh
    with pytest.raises(ValueError, match="one device.*fdt_torch.cli.train_pyramid --dp_devices"):
        run_pyramid_training(trainer(), str(write_dataset(tmp_path, 2)), TrainConfig(),
                             mesh=make_mesh(devices=["cpu"] * 2))


def test_prefetch_batches_float16_and_shutdown():
    """Batches arrive as float16 tensors; closing the generator stops the
    worker thread; a worker exception re-raises in the consumer."""
    class TinyDataset:
        def __len__(self):
            return 8

        def batches(self, batch_size):
            while True:
                yield (np.full((batch_size, 8, 8, 3), 1 / 3, np.float32),
                       [np.zeros((1, 5), np.float32)] * batch_size)

    before = {t.ident for t in threading.enumerate()}
    stats = {}
    gen = prefetch_batches(TinyDataset(), 2, depth=2, stats=stats)
    images, targets = next(gen)
    assert images.dtype == torch.float16 and float(images[0, 0, 0, 0]) == float(np.float16(1 / 3))
    worker = [t for t in threading.enumerate() if t.ident not in before]
    assert worker and stats["augmented"] >= 2
    gen.close()
    for _ in range(50):
        if not any(t.is_alive() for t in worker):
            break
        time.sleep(0.1)
    assert not any(t.is_alive() for t in worker)

    class Broken(TinyDataset):
        def batches(self, batch_size):
            raise FileNotFoundError("missing.jpg")
            yield

    with pytest.raises(FileNotFoundError):
        next(prefetch_batches(Broken(), 2))
    with pytest.raises(ValueError, match="batch_size"):
        next(prefetch_batches(TinyDataset(), 9))


def test_loss_history_drains_once_and_guards_its_buffer(tmp_path):
    h = LossHistory(save_point=2)
    for i in range(3):
        h.append({k: torch.tensor(float(i + j)) for j, k in
                  enumerate(("loss", "face_loc", "face_conf", "head_loc", "head_conf"))})
    h.save(str(tmp_path / "h.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "h.npy")[:, 0], [0, 1, 2, 3, 4])
    for i in range(4):
        h.append({k: torch.tensor(0.0) for k in
                  ("loss", "face_loc", "face_conf", "head_loc", "head_conf")})
    with pytest.raises(IndexError):
        h.drain()


def test_watchdog_fires_on_stall_and_not_while_beating():
    fired = []
    w = StallWatchdog(0.2, on_stall=fired.append, poll_s=0.02)
    time.sleep(0.3)
    assert not fired                     # no first beat yet: exempt
    w.beat()
    for _ in range(5):
        time.sleep(0.05)
        w.beat()
    assert not fired
    time.sleep(0.4)
    assert fired
    w.close()
    startup = []
    s = StallWatchdog(5.0, on_stall=startup.append, poll_s=0.02, startup_limit_s=0.1)
    time.sleep(0.3)
    assert startup
    s.close()
    assert STALL_EXIT_CODE == 86
    off = StallWatchdog(0)
    assert off._thread is None


@pytest.mark.parametrize("variant,npz", [("repo", "repo_mini"), ("try1", "try1_distilled_mini"),
                                         ("try3", "try3_mini")])
def test_to_jax_variables_inverts_from_jax_variables(variant, npz):
    """fdt's npz → the port's model → to_jax_variables: the same leaves,
    bit for bit, under fdt's flax paths (nested stages, joined Sequential
    indices)."""
    from fdt_torch.models.loader import from_jax_variables, load_npz
    variables = load_npz(str(REPO / "net_weight" / f"{npz}.npz"))
    model = build_pyramidbox(variant)
    model.load_state_dict(from_jax_variables(variables))
    want, got = flat_variables(variables), flat_variables(to_jax_variables(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
