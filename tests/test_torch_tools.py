"""The port's checkpoint tooling and debug tools against fdt's scripts:
train_chained (its journal, phases, retry rule and the chunk commands),
train_pyramid --journal, gen_anno, export_weights, select_checkpoint, the
debug visualizers, and the package exports against fdt's `__all__`.

fdt's scripts are loaded by importlib spec (as tests/test_watchdog.py
does) and their mains run in this process with a recorder in place of the
chunk processes.  The two-process chained run is in
tests/test_torch_chained.py.
"""
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt_torch.cli import (export_weights, gen_anno, select_checkpoint,  # noqa: E402
                           train_chained, train_pyramid)

torch.set_num_threads(1)

TRY3 = REPO / "net_weight" / "try3_mini.npz"


def fdt_script(name: str):
    spec = importlib.util.spec_from_file_location(f"fdt_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fdt_chained():
    return fdt_script("train_chained")


def test_journal_and_phases_equal_fdt(fdt_chained):
    assert train_chained.JOURNAL == fdt_chained.JOURNAL
    for name in fdt_chained.JOURNAL:
        for scale in (1.0, 0.5, 1e-3, 2.4e-4, 1.2e-4, 1e-9):
            for cap in (None, 4, 10000, 0):
                assert (train_chained.journal_phases(name, scale, cap)
                        == fdt_chained.journal_phases(name, scale, cap)), (name, scale, cap)


@pytest.mark.parametrize("codes, retries", [([0], 2), ([86, 86, 0], 2), ([86, 86, 86], 2),
                                            ([86, 3], 5), ([5], 2), ([86], 0)])
def test_run_chunk_retries_only_on_the_stall_code_as_fdt(fdt_chained, codes, retries, capsys):
    def recorder(seq):
        it = iter(seq)
        calls = []

        def call(cmd):
            calls.append(cmd)
            return next(it)
        return call, calls

    ours, our_calls = recorder(codes)
    theirs, their_calls = recorder(codes)
    a = train_chained.run_chunk(["x"], retries, "0..2", "ck", call=ours)
    b = fdt_chained.run_chunk(["x"], retries, "0..2", "ck", call=theirs)
    assert a == b and len(our_calls) == len(their_calls)
    assert train_chained.STALL_EXIT_CODE == fdt_chained.STALL_EXIT_CODE == 86


def _commands(monkeypatch, module, run):
    """The chunk commands `run()` builds, each chunk reported done."""
    cmds = []
    monkeypatch.setattr(module, "run_chunk", lambda cmd, *a, **k: cmds.append(cmd) or 0)
    run()
    return cmds


@pytest.mark.parametrize("argv", [
    ["--net", "try3", "--journal", "try3", "--journal-scale", "2.4e-4", "--chunk", "2",
     "--iter", "0", "--resume", "net_weight/try3_mini.npz", "--stall-retries", "0",
     "--device", "cpu", "--input_size", "640", "--batch_size", "2"],
    ["--net", "repo", "--journal", "repo", "--journal-scale", "1e-3", "--chunk", "4",
     "--start_iter", "5", "--save_folder", "w/"],
    ["--net", "try1", "--chunk", "3", "--iter", "7", "--lr", "1e-4"],
])
def test_chunk_commands_are_fdt_s_with_the_module_swapped(monkeypatch, capsys, fdt_chained,
                                                          argv):
    ours = _commands(monkeypatch, train_chained, lambda: train_chained.main(argv))
    ours_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train_chained.py"] + argv)
    theirs = _commands(monkeypatch, fdt_chained, fdt_chained.main)
    theirs_out = capsys.readouterr().out
    assert ours and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a[:3] == [sys.executable, "-m", "fdt_torch.cli.train_pyramid"]
        assert b[1].endswith("scripts/train_pyramid.py")
        assert a[3:] == b[2:]
    # the same journal lines and the same closing checkpoint
    assert ([ln for ln in ours_out.splitlines() if ln.startswith("# journal")]
            == [ln for ln in theirs_out.splitlines() if ln.startswith("# journal")])
    assert ours_out.splitlines()[-1] == theirs_out.splitlines()[-1]


def test_chained_run_stops_at_a_failed_chunk(monkeypatch):
    calls = []
    monkeypatch.setattr(train_chained, "run_chunk", lambda cmd, *a, **k: calls.append(cmd) or 7)
    assert train_chained.main(["--chunk", "2", "--iter", "6"]) == 7
    assert len(calls) == 1


def test_train_pyramid_journal_goes_through_train_chained(monkeypatch):
    """train_pyramid --journal hands train_chained the flags fdt's script
    hands scripts/train_chained.py (--device in place of --platform)."""
    argv = ["--net", "try3", "--journal", "try3", "--iter", "9", "--start_iter", "2",
            "--save_folder", "w/", "--annoPath", "a.txt", "--resume", "r.npz",
            "--input_size", "256", "--stall_timeout", "30", "--startup_timeout", "90",
            "--batch_size", "3", "--save_point", "5"]
    got = []
    monkeypatch.setattr(train_chained, "main", lambda a: got.append(a) or 0)
    assert train_pyramid.main(argv + ["--device", "cpu"]) == 0
    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    monkeypatch.setattr(sys, "argv", ["train_pyramid.py"] + argv + ["--platform", "cpu"])
    with pytest.raises(SystemExit) as e:
        fdt_script("train_pyramid").main()
    assert e.value.code == 0
    want = calls[0][2:]
    assert calls[0][1].endswith("scripts/train_chained.py")
    i = want.index("--platform")
    assert got[0] == want[:i] + ["--device", "cpu"] + want[i + 2:]


def test_gen_anno_equals_fdt_script(tmp_path, capsys):
    """The file and the printed lines of fdt's script, with WIDER's zero-face
    record (one all-zero box, which the validator flags)."""
    gt = tmp_path / "bbx_gt.txt"
    gt.write_text("0--Parade/a.jpg\n2\n1 2 3 4 0 0 0 0 0 0\n5 6 7 8 1 0 0 0 0 0\n"
                  "1--Handshaking/b.jpg\n1\n0 0 0 0 0 0 0 0 0 0\n"
                  "2--Demo/c.jpg\n1\n10 20 30 40 0 0 0 0 0 0\n")
    assert gen_anno.main([str(gt), "imgs", str(tmp_path / "ours")]) == 0
    ours = capsys.readouterr().out
    fdt = fdt_script("gen_anno")
    sys_argv = sys.argv
    sys.argv = ["gen_anno.py", str(gt), "imgs", str(tmp_path / "theirs")]
    try:
        fdt.main()
    finally:
        sys.argv = sys_argv
    assert ours == capsys.readouterr().out
    assert "100 error in line: 2" in ours and ours.endswith("test finished\n")
    assert (tmp_path / "ours").read_text() == (tmp_path / "theirs").read_text()


def test_export_weights_npz_pth_npz_round_trip(tmp_path, capsys):
    """A checkpoint directory → .pth → npz: fdt's layout (f16 params, f32
    batch_stats), equal to fdt's own export of the same variables; --check
    loads the written file into a detector on the CPU."""
    from fdt.models.loader import load_variables, save_variables_npz
    from fdt_torch.models import load_pyramidbox
    from fdt_torch.train.checkpoint import VARIABLES
    from fdt_torch.models.loader import save_variables_npz as port_save_npz, to_jax_variables
    ck = tmp_path / "try3_pyramid_2"
    ck.mkdir()
    port_save_npz(to_jax_variables(load_pyramidbox(str(TRY3), "try3")), str(ck / VARIABLES),
                  dtype=np.float32, compress=False)
    pth, npz = str(tmp_path / "w.pth"), str(tmp_path / "w.npz")
    assert export_weights.main(["--checkpoint", str(ck), "--out", pth]) == 0
    assert export_weights.main(["--checkpoint", pth, "--out", npz, "--net", "try3",
                                "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "wrote" in out and "check:" in out and "on the seeded frame" in out
    save_variables_npz(load_variables(None, str(TRY3), 0), str(tmp_path / "fdt.npz"))
    with np.load(npz) as got, np.load(tmp_path / "fdt.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(TRY3) as orig, np.load(npz) as got:  # the repo's npz, exactly
        for k in orig.files:
            np.testing.assert_array_equal(got[k], orig[k], err_msg=k)


def _checkpoints(directory: pathlib.Path) -> list:
    """Three checkpoint directories of try3: the repo's npz and two with
    seeded noise on the confidence heads, in float32 as the trainer saves
    them."""
    from fdt_torch.models import load_npz
    from fdt_torch.models.loader import flat_variables
    from fdt_torch.train.checkpoint import VARIABLES
    base = flat_variables(load_npz(str(TRY3)))
    rng = np.random.RandomState(0)
    out = []
    for step, noise in ((10, 0.0), (20, 0.05), (30, 0.2)):
        flat = {k: (v + noise * rng.standard_normal(v.shape).astype(np.float32)
                    if k.startswith("params/") and "conf" in k else v)
                for k, v in base.items()}
        path = directory / f"try3_pyramid_{step}"
        path.mkdir()
        np.savez(path / VARIABLES, **flat)
        out.append(path)
    return out


def test_select_checkpoint_aps_are_fdt_s_protocol(tmp_path, monkeypatch, capsys):
    """Three checkpoints on four seeded drawn-face images (the shared square
    cut to 160² for the CPU): the CLI's APs equal fdt's TfConfAccumulator /
    average_precision over the port's rows, one detector for every
    checkpoint, and the JSON line is fdt's."""
    from fdt.eval.pr import TfConfAccumulator, average_precision
    from fdt_torch.infer.pyramidbox import detections_to_rows
    from fdt_torch.models import load_pyramidbox_detector
    from fdt_torch.train.checkpoint import load_model_weights
    monkeypatch.setattr(select_checkpoint, "SIZE", 160)
    paths = _checkpoints(tmp_path)
    anno = chip_smoke.write_face_val_set(tmp_path, n=4)
    built = []
    real = load_pyramidbox_detector

    def counting(*a, **k):
        built.append(a)
        return real(*a, **k)
    monkeypatch.setattr("fdt_torch.models.loader.load_pyramidbox_detector", counting)
    assert select_checkpoint.main(["--net", "try3", "--checkpoints",
                                   str(tmp_path / "try3_pyramid_*"), "--val", str(anno),
                                   "--device", "cpu"]) == 0
    assert len(built) == 1
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    assert set(line) == {"net", "aps", "best", "best_ap"}
    assert [ln.split(":")[0] for ln in out[:-1]] == [f"# {p}" for p in paths]
    val = select_checkpoint.load_val(str(anno))
    want = {}
    for path in paths:
        det = load_pyramidbox_detector("try3", None, budget=2048, device="cpu")
        load_model_weights(str(path), det.model)
        acc = TfConfAccumulator()
        for img, gt in val:
            t = det.detect_tensor(img[None], conf_thresh=0.05, nms_thresh=0.35)[0]
            acc.add(detections_to_rows(t, 0.1, [160] * 4), gt)
        want[path.name] = round(float(average_precision(acc.finalize())), 4)
    assert line["aps"] == want
    assert line["best"] == max(want, key=want.get) and line["best_ap"] == max(want.values())
    assert len(set(want.values())) > 1  # the checkpoints differ in AP


def test_draw_matched_anchors_equals_fdt(tmp_path):
    """The matched set is fdt's (facebox_encode's conf != 0) and the images
    are fdt's cv2 drawings pixel for pixel; each writes its three JPEGs."""
    from fdt.utils.visualize import draw_matched_anchors as fdt_draw
    from fdt_torch.data.image_io import imread
    from fdt_torch.utils.visualize import draw_matched_anchors, matched_anchors
    img = np.random.RandomState(1).randint(0, 256, (160, 160, 3), np.uint8)
    gt = np.array([[0.1, 0.1, 0.3, 0.35], [0.5, 0.4, 0.9, 0.95],
                   [0.95, 0.9, 1.05, 1.1], [0.02, 0.6, 0.06, 0.64]], np.float32)
    want = fdt_draw(img, gt, str(tmp_path / "fdt"))
    got = draw_matched_anchors(img, gt, str(tmp_path / "port"))
    import jax.numpy as jnp
    from fdt.anchors.densified import facebox_default_boxes, facebox_encode
    _, conf = facebox_encode(jnp.asarray(gt), jnp.ones(len(gt), jnp.int32),
                             jnp.ones(len(gt), bool), facebox_default_boxes(), 0.35)
    matched = matched_anchors(gt)
    assert matched.sum() > len(gt)
    np.testing.assert_array_equal(matched, np.asarray(conf) != 0)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"group {i}")
        assert imread(str(tmp_path / f"port_{i}.jpg")).shape == img.shape


def test_circle_offsets_are_cv2_circles():
    import cv2
    from fdt_torch.utils.visualize import circle_offsets
    for r in range(8):
        want = np.zeros((21, 21), np.uint8)
        cv2.circle(want, (10, 10), r, 255)
        got = np.zeros_like(want)
        for dx, dy in circle_offsets(r):
            got[10 + dy, 10 + dx] = 255
        np.testing.assert_array_equal(got, want, err_msg=f"radius {r}")


def test_vis_two_and_vis_face_write_their_files(tmp_path):
    from fdt_torch.utils.visualize import vis_face, vis_two
    img = np.random.RandomState(2).randint(0, 256, (48, 64, 3), np.uint8)
    dets = np.array([[4, 5, 30, 40, 0.95] + [10, 12] * 5, [1, 1, 9, 9, 0.5] + [0] * 10],
                    np.float32)
    assert vis_two(img, dets, dets + 1, save_path=str(tmp_path / "two.png")) is None
    assert vis_face(img, dets[:, :5], dets[:, 5:], save_path=str(tmp_path / "face.png")) is None
    for name in ("two.png", "face.png"):
        assert (tmp_path / name).stat().st_size > 1000
    fig = vis_face(img, dets[:, :5])
    assert fig is not None


# fdt's exported names that the port keeps under another name, or not at all
RENAMED = {("models", "torch_to_flax"): "load_reference_state_dict"}
NOT_PORTED = {("ops", "pallas_nms_keep"),  # the port's is fdt_torch.ops.nms.nms_keep_greedy
              ("train", "TrainState"),      # the port's trainers hold their state
              ("utils", "Timer"), ("utils", "benchmark"), ("utils", "trace")}


@pytest.mark.parametrize("package", ["geometry", "ops", "models", "infer", "train", "data",
                                     "eval", "track", "anchors", "utils"])
def test_exports_cover_fdt_all(package):
    """Each name of fdt's `__all__` is exported by the port's package of the
    same name (by RENAMED's name), except NOT_PORTED, which ROADMAP lists."""
    fdt_pkg = importlib.import_module(f"fdt.{package}")
    ours = importlib.import_module(f"fdt_torch.{package}")
    for name in fdt_pkg.__all__:
        if (package, name) in NOT_PORTED:
            continue
        name = RENAMED.get((package, name), name)
        assert hasattr(ours, name), f"fdt_torch.{package}.{name}"
        assert name in getattr(ours, "__all__", ()), f"fdt_torch.{package}.__all__: {name}"


def test_new_geometry_and_ops_exports_behave():
    """pair_distance is fdt's; Int8Conv is the port's Int8Conv2d."""
    import jax.numpy as jnp
    from fdt.geometry import pair_distance as fdt_pair
    from fdt_torch.geometry import pair_distance
    from fdt_torch.geometry.track import _distance_row
    from fdt_torch.ops import Int8Conv, Int8Conv2d
    rng = np.random.RandomState(3)
    a = np.sort(rng.rand(5, 4).astype(np.float32).reshape(5, 2, 2), axis=1).reshape(5, 4)
    b = np.sort(rng.rand(3, 4).astype(np.float32).reshape(3, 2, 2), axis=1).reshape(3, 4)
    got = pair_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(fdt_pair(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)  # pow(·, 0.25) by two libraries
    for j in range(3):
        assert torch.equal(_distance_row(torch.from_numpy(a), torch.from_numpy(b[j])),
                           torch.from_numpy(got[:, j]))
    assert Int8Conv is Int8Conv2d
