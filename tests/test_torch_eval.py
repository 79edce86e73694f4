"""The port's WIDER eval against fdt's: anno, collector, pr, runner, batched
eval, curves and the eval CLIs.

The anno files of data/mini name images that are not in the repo; here
they are rewritten to point at seeded noise PNGs written under tmp_path
(chip_smoke.encode_png), so that fdt's collector (cv2.imread) and the
port's (image_io.imread) read the same pixels.  Numpy code is held to fdt
bit for bit; the depth-cut flagship of tests/test_torch_detector.py runs the
eval as a whole within its float32 tolerance."""
import pathlib
import subprocess
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import fdt.data.anno as jax_anno  # noqa: E402
import fdt.eval.batched as jax_batched  # noqa: E402
import fdt.eval.curves as jax_curves  # noqa: E402
import fdt.eval.pr as jax_pr  # noqa: E402
import fdt.eval.runner as jax_runner  # noqa: E402
from fdt.data.collector import EvalCollector as JaxCollector  # noqa: E402
from fdt_torch.data import anno  # noqa: E402
from fdt_torch.data.collector import EvalCollector  # noqa: E402
from fdt_torch.eval import batched, curves, pr, runner  # noqa: E402

torch.set_num_threads(1)

MINI = REPO / "data" / "mini"
SIZES = ((96, 128), (120, 160), (80, 100))  # (h, w) of the synthetic images
CLI = ["serve", "my_test", "my_test_facebox", "my_test_mtcnn", "merge_eval", "draw_curves"]


def _rewrite(src: pathlib.Path, tmp: pathlib.Path) -> str:
    """src's anno lines with each image path replaced by a seeded noise PNG
    under tmp; returns the new anno file's path."""
    lines = []
    for k, line in enumerate(src.read_text().splitlines()):
        cells = line.split()
        path = tmp / (pathlib.Path(cells[0]).stem + ".png")
        img = np.random.RandomState(k).randint(0, 256, (*SIZES[k % 3], 3), dtype=np.uint8)
        path.write_bytes(chip_smoke.encode_png(img, k % 5))
        lines.append(" ".join([str(path)] + cells[1:]))
    out = tmp / src.name
    out.write_text("\n".join(lines) + "\n")
    return str(out)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mini")
    return {f.name: _rewrite(f, tmp) for f in sorted(MINI.iterdir())}


@pytest.fixture(scope="module")
def val(mini):
    return mini["gen_anno_file_mini_val"]


def _fake_detect(image):
    """A deterministic function of the image (the same boxes in any shard),
    with exactly tied confidences across images (tests/test_eval_parts.py)."""
    rng = np.random.RandomState(int(image[::7, ::7].sum()) % (2 ** 31))
    n = rng.randint(1, 6)
    h, w = image.shape[:2]
    x1 = rng.rand(n) * (w - 20)
    y1 = rng.rand(n) * (h - 20)
    side = 10 + rng.rand(n) * 60
    conf = np.round(rng.rand(n), 1)
    return np.column_stack([x1, y1, x1 + side, y1 + side, conf])


# -- anno and collector -------------------------------------------------------

@pytest.mark.parametrize("name", ["gen_anno_file_mini_train", "gen_anno_file_mini_val"])
def test_anno_parse_and_validate_equal_fdts(mini, name):
    for path in (str(MINI / name), mini[name]):
        ours, theirs = anno.parse_anno_file(path), jax_anno.parse_anno_file(path)
        assert [r.path for r in ours] == [r.path for r in theirs] and len(ours) > 3
        for a, b in zip(ours, theirs):
            assert a.boxes_xywh.dtype == b.boxes_xywh.dtype == np.int32
            np.testing.assert_array_equal(a.boxes_xywh, b.boxes_xywh)
        assert anno.validate_anno_file(path) == jax_anno.validate_anno_file(path)


def test_anno_validate_flags_equal_fdts(tmp_path):
    p = tmp_path / "anno"
    p.write_text("a.jpg 1 1 2 3 4\nb.jpg 1 0 0 0 0\nc.jpg 2 1 2 3 4 5 6 7\nd.png 1 1 1 1 1\n")
    assert anno.validate_anno_file(str(p)) == jax_anno.validate_anno_file(str(p)) == [
        "100 error in line: 2", "%4 error in line: 3", "100 error in line: 4"]


def test_generate_anno_file_equal_fdts(tmp_path):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(7):
        lines.append(f"{i % 3}--Event/{i}_img.jpg")
        n = int(rng.randint(0, 4)) or 1
        lines.append(str(n))
        lines += [" ".join(str(v) for v in rng.randint(0, 500, 4)) + " 0 0 0 0 0 0 "
                  for _ in range(n)]
    (tmp_path / "bbx_gt.txt").write_text("\n".join(lines) + "\n")
    outs = []
    for mod, name in ((anno, "ours"), (jax_anno, "theirs")):
        n = mod.generate_anno_file(str(tmp_path / "bbx_gt.txt"), "IMG/val", str(tmp_path / name))
        outs.append((n, (tmp_path / name).read_text()))
    assert outs[0] == outs[1] and outs[0][0] == 7
    bad = tmp_path / "bad.txt"
    bad.write_text("not-an-image\n1\n")
    with pytest.raises(ValueError, match="malformed"):
        anno.generate_anno_file(str(bad), "IMG", str(tmp_path / "x"))


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_collector_equal_fdts_with_global_ids(val, shards):
    ours, theirs = [], []
    for i in range(shards):
        args = (i, shards) if shards > 1 else ()
        ours += list(EvalCollector(val, *args))
        theirs += list(JaxCollector(val, *args))
    assert [i for _, _, i in ours] == [i for _, _, i in theirs] == list(range(1, len(ours) + 1))
    for (img, tgt, _), (jimg, jtgt, _) in zip(ours, theirs):
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(tgt, jtgt)


def test_collector_raises_on_a_missing_image(tmp_path):
    p = tmp_path / "anno"
    p.write_text(f"{tmp_path / 'missing.png'} 1 1 2 3 4\n")
    with pytest.raises(FileNotFoundError):
        list(EvalCollector(str(p)))


# -- pr -----------------------------------------------------------------------

def _predict(rng, n):
    xy = rng.rand(n, 2) * 100
    wh = 5 + rng.rand(n, 2) * 40
    return np.column_stack([xy, xy + wh, np.round(rng.rand(n), 1)])


@pytest.mark.parametrize("seed", range(4))
def test_calc_pr_and_accumulator_bit_equal(seed):
    rng = np.random.RandomState(seed)
    ours, theirs = pr.TfConfAccumulator(0.4), jax_pr.TfConfAccumulator(0.4)
    for k in range(6):
        p = _predict(rng, rng.randint(0, 9))
        # GT: a few predictions' own boxes (true positives), none at k == 2
        t = np.column_stack([p[: k % 3, :2], p[: k % 3, 2:4] - p[: k % 3, :2]]).astype(np.int32)
        if len(p):
            a, b = pr.calc_pr(p, t, 0.4), jax_pr.calc_pr(p, t, 0.4)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        ours.add(p, t)
        theirs.add(p, t)
    np.testing.assert_array_equal(ours.finalize(), theirs.finalize())
    np.testing.assert_array_equal(ours.raw()[0], theirs.raw()[0])
    assert ours.raw()[1] == theirs.raw()[1]


def _dumps(seed, parts=3):
    rng = np.random.RandomState(seed)
    raws, finals = [], []
    for _ in range(parts):
        acc = pr.TfConfAccumulator()
        for _ in range(3):
            p = _predict(rng, rng.randint(1, 6))
            acc.add(p, np.column_stack([p[:1, :2], p[:1, 2:4] - p[:1, :2]]).astype(np.int32))
        raws.append(acc.raw())
        finals.append(acc.finalize())
    return raws, finals


@pytest.mark.parametrize("seed", range(3))
def test_merges_and_curves_bit_equal(tmp_path, seed):
    raws, finals = _dumps(seed)
    merged = pr.merge_raw(raws)
    np.testing.assert_array_equal(merged, jax_pr.merge_raw(raws))
    np.testing.assert_array_equal(pr.merge_dumps(finals), jax_pr.merge_dumps(finals))
    paths = []
    for i, raw in enumerate(raws):
        paths.append(str(tmp_path / f"d.part{i}_of_{len(raws)}.npz"))
        pr.save_raw_part(raw, paths[-1])
    np.testing.assert_array_equal(pr.merge_part_files(paths), jax_pr.merge_part_files(paths))
    np.testing.assert_array_equal(pr.merge_part_files(paths), merged)
    for fn in ("gen_tp_fp", "pr_curve", "roc_curve"):
        for a, b in zip(getattr(pr, fn)(merged), getattr(jax_pr, fn)(merged)):
            np.testing.assert_array_equal(a, b)
    assert pr.average_precision(merged) == jax_pr.average_precision(merged)
    assert pr.merge_raw([]).shape == jax_pr.merge_raw([]).shape == (2, 1)


# -- runner -------------------------------------------------------------------

def test_run_dump_bit_equal_to_fdts(tmp_path, val):
    ours = runner._run(_fake_detect, val, str(tmp_path / "ours.npy"), progress=False)
    theirs = jax_runner._run(_fake_detect, val, str(tmp_path / "theirs.npy"), progress=False)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.load(tmp_path / "ours.npy"), theirs)
    for kw in (dict(limit=3), dict(skip_ids=(2, 4)), dict(iou_thresh=0.3)):
        np.testing.assert_array_equal(runner._run(_fake_detect, val, "", progress=False, **kw),
                                      jax_runner._run(_fake_detect, val, "", progress=False,
                                                      **kw))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_parts_merge_bit_exact(tmp_path, mini, n):
    """The port's counterpart of tests/test_eval_parts.py, on its own images."""
    from fdt_torch.cli import merge_eval
    anno_file = mini["gen_anno_file_mini_train"]
    single = runner._run(_fake_detect, anno_file, str(tmp_path / "dump.npy"), progress=False)
    for i in range(n):
        runner._run(_fake_detect, anno_file, str(tmp_path / "dump.npy"), progress=False,
                    process_index=i, process_count=n)
    parts = [str(tmp_path / f"dump.part{i}_of_{n}.npz") for i in range(n)]
    np.testing.assert_array_equal(pr.merge_part_files(parts), single)
    np.testing.assert_array_equal(jax_pr.merge_part_files(parts), single)
    merge_eval.main(parts[::-1] + ["--out", str(tmp_path / "merged.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "merged.npy"), single)
    with pytest.raises(ValueError, match="ALL parts"):
        merge_eval.main(parts[:1] + ["--out", str(tmp_path / "m.npy")])


def test_run_rejects_a_lone_process_arg_and_display_without_a_server(tmp_path, val,
                                                                     monkeypatch):
    with pytest.raises(ValueError, match="together"):
        runner._run(_fake_detect, val, "", process_count=2)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="display server"):
        runner._run(_fake_detect, val, "", display=True)


def test_display_dir_writes_the_overlays(tmp_path, val):
    out = tmp_path / "shown"
    out.mkdir()
    dump = runner._run(_fake_detect, val, "", display_dir=str(out), progress=False, limit=2)
    np.testing.assert_array_equal(dump, jax_runner._run(_fake_detect, val, "", progress=False,
                                                        limit=2))
    assert sorted(p.name for p in out.iterdir()) == ["1.jpg", "2.jpg"]


class _FakeDetector:
    """detect_face / detect / detect_tensor of one deterministic function, for
    the eval functions of both packages."""

    def detect_face(self, image, threshold):
        return _fake_detect(image)

    def detect(self, image):
        r = _fake_detect(image)
        return r[:, :4], r[:, 4]

    def detect_tensor(self, images, conf_thresh, nms_thresh):
        out = np.zeros((len(images), 2, 8, 5), np.float32)
        for j, im in enumerate(images):
            r = _fake_detect(im)[:8]
            h, w = im.shape[:2]
            out[j, 1, :len(r), 0] = np.sort(r[:, 4])[::-1]
            out[j, 1, :len(r), 1:] = r[:, :4] / [w, h, w, h]
        return out


class _FakeCascade:
    """An MTCNN cascade's detect_face / detect_face_bucketed: (boxes, landmarks)."""

    last_saturated = False

    def detect_face(self, image):
        return _fake_detect(image), None

    def detect_face_bucketed(self, image):
        return _fake_detect(image), None


class _Saturating(_FakeCascade):
    last_saturated = True

    def detect_face(self, image):
        return np.array([]), np.array([])


@pytest.mark.parametrize("family", ["pyramidbox", "facebox", "mtcnn", "mtcnn-bucketed",
                                    "mtcnn-fallback"])
def test_eval_functions_bit_equal_to_fdts(val, family):
    det = _FakeDetector()
    if family == "pyramidbox":
        dumps = [mod.eval_pyramidbox(det, val, 0.0, progress=False)
                 for mod in (runner, jax_runner)]
    elif family == "facebox":
        dumps = [mod.eval_facebox(det, val, progress=False) for mod in (runner, jax_runner)]
    else:
        det, kw = _FakeCascade(), dict(bucketed=family == "mtcnn-bucketed", progress=False)
        if family == "mtcnn-fallback":
            det, kw["saturate_fallback"] = _Saturating(), _FakeCascade()
        with pytest.warns(UserWarning) if family == "mtcnn-fallback" else nullcontext():
            dumps = [mod.eval_mtcnn(det, val, **kw) for mod in (runner, jax_runner)]
    np.testing.assert_array_equal(dumps[0], dumps[1])
    assert dumps[0].shape[1] > 5


def test_eval_mtcnn_bucketed_needs_the_device_cascade(val):
    class Host:
        def detect_face(self, image):
            return _fake_detect(image), None
    with pytest.raises(ValueError, match="MTCNNDeviceCascade"):
        runner.eval_mtcnn(Host(), val, bucketed=True)
    with pytest.warns(UserWarning, match="saturated"):
        dump = runner.eval_mtcnn(_Saturating(), val, progress=False)
    assert dump.shape == (2, 1)  # every image empty, its GT still counted
    assert dump[1, -1] > 0


def test_bucket_for_and_batched_eval_bit_equal_to_fdts(tmp_path, mini):
    for w, h in ((1, 1), (128, 128), (129, 300), (1024, 683)):
        assert batched.bucket_for(w, h) == jax_batched.bucket_for(w, h)
    anno_file = mini["gen_anno_file_mini_train"]
    ours = batched.eval_pyramidbox_batched(_FakeDetector(), anno_file, 0.05, batch_size=2,
                                           dump_path=str(tmp_path / "d.npy"), progress=False)
    theirs = jax_batched.eval_pyramidbox_batched(_FakeDetector(), anno_file, 0.05,
                                                 batch_size=2, progress=False)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), theirs)


@pytest.fixture(scope="module")
def cut_detectors():
    """The depth-cut flagship of tests/test_torch_detector.py in both packages."""
    from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector
    from fdt.models.pyramidbox import PyramidBox as JaxPyramidBox
    from fdt_torch.infer import PyramidBoxDetector
    from fdt_torch.models import PyramidBox, from_jax_variables, load_npz
    from tests.test_torch_detector import CUT, _first_blocks
    variables = _first_blocks(load_npz(str(REPO / "net_weight" / "repo_mini.npz")))
    model = PyramidBox(CUT)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return (PyramidBoxDetector(model, device="cpu"),
            JaxDetector(variables, JaxPyramidBox(num_blocks=CUT), "repo", precision="highest"))


def test_eval_pyramidbox_as_a_whole_matches_fdt(tmp_path, cut_detectors):
    """The slice end to end on the CPU: PNG files → collector → detect_face
    (threshold 0.0, My_test.py's default, so the all-zero class-0 rows are
    walked too) → dump.  Detection counts, GT and true positives equal;
    sorted confidences within the detectors' float32 tolerance (1e-5)."""
    images = chip_smoke.eval_images(seed=9, n=4, sizes=((64, 80), (96, 96)))
    port, jdet = cut_detectors
    rows = [port.detect_face(im, 0.0) for im in images]
    boxes = [chip_smoke.gt_boxes(r, *im.shape[:2], np.random.RandomState(k))
             for k, (r, im) in enumerate(zip(rows, images))]
    anno_file = chip_smoke.write_eval_set(tmp_path, images, boxes)
    ours = runner.eval_pyramidbox(port, anno_file, 0.0, str(tmp_path / "data_of_repo.npy"),
                                  progress=False)
    np.testing.assert_array_equal(ours, chip_smoke.reference_dump(rows, anno_file))
    theirs = jax_runner.eval_pyramidbox(jdet, anno_file, 0.0, progress=False)
    assert ours.shape == theirs.shape and ours[1, -1] == theirs[1, -1] == 8
    assert ours[0].sum() == theirs[0].sum() > 0
    np.testing.assert_allclose(ours[1, :-1], theirs[1, :-1], rtol=0, atol=1e-5)


# -- curves and CLIs ----------------------------------------------------------

def test_curves_write_files_and_assemble_loss_equal_fdts(tmp_path):
    dump = np.array([[1, 0, 1, 0], [0.9, 0.8, 0.7, 3]])
    np.save(tmp_path / "data_of_x.npy", dump)
    curves.plot_pr_roc([str(tmp_path / "data_of_x.npy")], ["x"],
                       out_prefix=str(tmp_path / "curves"))
    assert (tmp_path / "curves_pr.png").stat().st_size > 1000
    assert (tmp_path / "curves_roc.png").stat().st_size > 1000
    curves.plot_curves([np.arange(5.0)], ["a"], "t", "x", "y", out_path=str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()
    rng = np.random.RandomState(1)
    files = []
    for k in range(2):
        a = np.zeros((5, 7))
        a[:, :4 + k] = rng.rand(5, 4 + k) + 0.1
        files.append(str(tmp_path / f"loss_{k}.npy"))
        np.save(files[-1], a)
    for kw in (dict(), dict(index=2), dict(smooth=2), dict(iseval=True, eval_freq=4),
               dict(isoverall=False)):
        np.testing.assert_array_equal(curves.assemble_loss(files, **kw),
                                      jax_curves.assemble_loss(files, **kw))


@pytest.mark.parametrize("name", CLI)
def test_cli_help(name):
    r = subprocess.run([sys.executable, "-m", f"fdt_torch.cli.{name}", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "usage" in r.stdout, r.stderr[-2000:]


@pytest.mark.parametrize("flag", [
    ["--quant", "int8", "--detector", "mtcnn", "--weights", "p.npz,r.npz,o.npz"],
    ["--dp_devices", "2"]])
def test_serve_cli_refuses_what_is_not_ported(flag):
    """--dp_devices is not ported; --quant int8 is (pyramid and facebox, in
    tests/test_torch_quant_detectors.py) and, as in fdt, refused for the
    mtcnn cascade."""
    from fdt_torch.cli import serve
    with pytest.raises(SystemExit, match="not ported|not supported for the mtcnn"):
        serve.main(flag + ["--device", "cpu", "--no_warmup"])


def test_eval_and_curve_clis_run_on_the_cpu(tmp_path, val, capsys):
    from fdt_torch.cli import draw_curves, my_test
    my_test.main(["--net", "try3", "--anno", val, "--data_save_folder", str(tmp_path),
                  "--limit", "2", "--device", "cpu"])
    assert "detections:" in capsys.readouterr().out
    dump = np.load(tmp_path / "data_of_try3.npy")
    assert dump.shape[0] == 2 and dump[1, -1] > 0
    draw_curves.main(["pr_roc", str(tmp_path / "data_of_try3.npy"), "--out",
                      str(tmp_path / "curves")])
    assert (tmp_path / "curves_pr.png").exists()
    assert "try3: AP" in capsys.readouterr().out


def test_live_window_shows_each_image_and_saves_on_s(tmp_path, val, monkeypatch):
    """display=True where a display server is named: each overlay goes to the
    window (matplotlib, here its Agg backend) and 's' saves the one shown."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    monkeypatch.setenv("DISPLAY", ":0")
    shown = []
    monkeypatch.setattr(plt, "pause", lambda s: shown.append(s))
    windows = []
    window_cls = runner._LiveWindow

    class Kept(window_cls):
        def __init__(self, *a):
            super().__init__(*a)
            windows.append(self)

    monkeypatch.setattr(runner, "_LiveWindow", Kept)
    dump = runner._run(_fake_detect, val, "", display=True, snapshot_dir=str(tmp_path),
                       snapshot_prefix="snap", progress=False, limit=2)
    assert shown == [1.0, 1.0] and dump.shape[1] > 1

    class Key:
        key = "s"
    windows[0]._key(Key())
    assert (tmp_path / "snap_0.jpg").exists()
    plt.close("all")
