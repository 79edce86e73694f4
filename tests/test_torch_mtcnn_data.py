"""fdt_torch's MTCNN data pipeline (imdb parsing, flips, batches, assembly
and the three patch factories) against fdt's (fdt/data/mtcnn_data.py), on
scenes the tests write as PNGs, which Pillow and cv2 decode bit-equal.

The factories draw from the same RandomState calls in fdt's order, so the
same seed gives the same crop boxes, offsets, labels, counts and anno
lines, exactly.  The patches differ where the two sides' tools do:
  * before encoding, each patch is within 1 gray level of cv2.resize's
    (the port resizes in float and rounds; cv2 in 11-bit fixed point);
  * the files are JPEGs at quality 95 from Pillow where fdt's are cv2's
    (the two encoders give the same file for the same pixels here; the
    1-level differences of the resize are what JPEG spreads): decoded,
    every positive and negative patch is within JPEG_MAX_DIFF gray levels
    of fdt's (measured 12) and within JPEG_MEAN_DIFF on average (measured
    0.91-1.42 by scene and size).
"""
import os
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.data import mtcnn_data as jax_data  # noqa: E402
from fdt_torch.data import image_io, mtcnn_data  # noqa: E402

cv2 = pytest.importorskip("cv2")

JPEG_MAX_DIFF, JPEG_MEAN_DIFF = 16, 2.0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two scene sets, each (anno file in the factory format, prefix):
    "faces", chip_smoke.write_mtcnn_set's 3 drawn-face PNGs; "noise", fdt's
    own test scene (a 320×240 noise image, one 60×50 face) as a PNG."""
    root = tmp_path_factory.mktemp("scenes")
    faces = chip_smoke.write_mtcnn_set(root, n=3)
    rng = np.random.RandomState(5)
    cv2.imwrite(str(root / "scene.png"), (rng.rand(240, 320, 3) * 255).astype(np.uint8))
    noise = root / "noise_anno.txt"
    noise.write_text("scene.png 100 80 159 129\n")
    return {"faces": (str(faces), ""), "noise": (str(noise), str(root))}


def _relative(lines, out_dir):
    return [line.replace(str(out_dir), "<out>") for line in lines]


def _anno_lines(out_dir, size, kinds=("pos", "neg", "part")):
    return {k: _relative(open(os.path.join(out_dir, "anno_store", f"{k}_{size}.txt")).readlines(),
                         out_dir) for k in kinds}


def _run_both(monkeypatch, tmp_path, run):
    """run(module, out_dir, on_patch) on fdt's and the port's module: their
    observed patches (kind, crop, offsets), the patches handed to the
    writers, and the stats; fdt's cv2.imwrite and the port's imwrite are
    wrapped to keep each patch and still write it."""
    out = {}
    for name, module, writer_owner in (("fdt", jax_data, cv2), ("port", mtcnn_data, image_io)):
        seen, written = [], []
        real = writer_owner.imwrite

        def write(path, img, _real=real, _written=written):
            _written.append(np.array(img))
            return _real(path, img)

        monkeypatch.setattr(writer_owner, "imwrite", write)
        out_dir = tmp_path / name
        st = run(module, str(out_dir), lambda k, c, o, _s=seen: _s.append((k, np.array(c), o)))
        monkeypatch.setattr(writer_owner, "imwrite", real)
        out[name] = {"seen": seen, "written": written, "stats": st, "dir": out_dir}
    return out["fdt"], out["port"]


def _check_same_patches(theirs, ours, size):
    assert (ours["stats"].pos, ours["stats"].neg, ours["stats"].part) == (
        theirs["stats"].pos, theirs["stats"].neg, theirs["stats"].part)
    assert len(ours["seen"]) == len(theirs["seen"]) > 0
    for (k1, c1, o1), (k2, c2, o2) in zip(ours["seen"], theirs["seen"]):
        assert k1 == k2
        np.testing.assert_array_equal(c1, c2)
        assert o1 == o2
    assert len(ours["written"]) == len(theirs["written"])
    for a, b in zip(ours["written"], theirs["written"]):
        assert a.shape == b.shape == (size, size, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert _anno_lines(ours["dir"], size) == _anno_lines(theirs["dir"], size)
    diffs = []
    for line in (open(os.path.join(ours["dir"], "anno_store", f"pos_{size}.txt")).readlines()
                 + open(os.path.join(ours["dir"], "anno_store", f"neg_{size}.txt")).readlines()):
        path = line.split()[0]
        mine = image_io.imread(path)
        fdts = cv2.imread(path.replace(str(ours["dir"]), str(theirs["dir"])))
        diffs.append(np.abs(mine.astype(int) - fdts.astype(int)))
    assert max(d.max() for d in diffs) <= JPEG_MAX_DIFF
    assert np.mean([d.mean() for d in diffs]) <= JPEG_MEAN_DIFF


@pytest.mark.parametrize("scene", ["faces", "noise"])
def test_gen_pnet_train_data_matches_fdt(scenes, monkeypatch, tmp_path, scene):
    anno, prefix = scenes[scene]

    def run(module, out_dir, on_patch):
        return module.gen_pnet_train_data(anno, prefix, out_dir, np.random.RandomState(0),
                                          neg_per_image=20, on_patch=on_patch)

    theirs, ours = _run_both(monkeypatch, tmp_path, run)
    assert ours["stats"].pos > 0 and ours["stats"].part > 0
    _check_same_patches(theirs, ours, 12)


def fake_detector(img):
    """A previous stage's stand-in: boxes in every IoU bucket of the noise
    scene's face and more negatives than the cap (fdt's test's)."""
    rows = [[105, 70, 160, 125, 0.9], [110, 70, 175, 135, 0.8], [110, 60, 180, 130, 0.7]]
    rows += [[10 + 14 * i, 150 + 4 * i, 50 + 14 * i, 190 + 4 * i, 0.5] for i in range(8)]
    return np.array(rows, np.float32)


@pytest.mark.parametrize("size", [24, 48])
def test_gen_hard_example_data_matches_fdt(scenes, monkeypatch, tmp_path, size):
    anno, prefix = scenes["noise"]

    def run(module, out_dir, on_patch):
        return module.gen_hard_example_data(fake_detector, anno, prefix, out_dir, size,
                                            neg_cap_per_image=5, on_patch=on_patch)

    theirs, ours = _run_both(monkeypatch, tmp_path, run)
    assert ours["stats"].neg == 5 and ours["stats"].pos > 0 and ours["stats"].part > 0
    _check_same_patches(theirs, ours, size)


def test_gen_hard_example_skips_images_without_boxes(scenes, tmp_path):
    anno, prefix = scenes["noise"]
    for module in (jax_data, mtcnn_data):
        st = module.gen_hard_example_data(lambda img: None, anno, prefix,
                                          str(tmp_path / module.__name__), 24)
        assert (st.pos, st.neg, st.part) == (0, 0, 0)


def test_gen_landmark_data_matches_fdt(scenes, tmp_path):
    anno, _ = scenes["faces"]
    rows = []
    for line in open(anno).read().splitlines():
        path, *c = line.split()
        x1, y1, x2, y2 = map(float, c[:4])
        pts = np.array([[0.3, 0.35], [0.7, 0.35], [0.5, 0.55], [0.35, 0.75], [0.65, 0.75]])
        pts = pts * [x2 - x1, y2 - y1] + [x1, y1]
        rows.append(f"{path} {x1} {x2} {y1} {y2} " + " ".join(f"{v:.1f}" for v in pts.ravel()))
    lm_anno = tmp_path / "lm.txt"
    lm_anno.write_text("\n".join(rows) + "\n")
    counts, lines = [], []
    for module in (jax_data, mtcnn_data):
        out = tmp_path / module.__name__.split(".")[0]
        counts.append(module.gen_landmark_data(str(lm_anno), "", str(out)))
        lines.append(_relative(open(out / "anno_store" / "landmark_48.txt").readlines(), out))
    assert counts[0] == counts[1] == 3 and lines[0] == lines[1]


def test_parse_imdb_and_flips_match_fdt(tmp_path):
    anno = tmp_path / "anno.txt"
    (tmp_path / "b.jpg").write_bytes(b"")
    anno.write_text("a.jpg 1 0.1 0.2 0.3 0.4\n"
                    f"{tmp_path / 'b'} 0\n"
                    "sub\\c 0 0.5 0.5 0.5 0.5\n"
                    "d.jpg -2 0 0 0 0 0.1 0.2 0.3 0.4 0.5 0.6 0.7 0.8 0.9 1.0\n"
                    "e.jpg -1 -0.1 0.2 0.05 -0.3\n")
    ours = mtcnn_data.append_flipped_images(mtcnn_data.parse_mtcnn_imdb(str(anno), "pre"))
    theirs = jax_data.append_flipped_images(jax_data.parse_mtcnn_imdb(str(anno), "pre"))
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        assert (a["image"], a["label"], a["flipped"]) == (b["image"], b["label"], b["flipped"])
        np.testing.assert_array_equal(a["bbox_target"], b["bbox_target"])
        np.testing.assert_array_equal(a["landmark_target"], b["landmark_target"])
    assert ours[2]["image"] == "pre/sub/c.jpg"
    np.testing.assert_allclose(ours[5]["bbox_target"], [-0.3, 0.2, -0.1, 0.4])


@pytest.mark.parametrize("seed", [0, 1])
def test_mtcnn_batches_match_fdt(tmp_path, seed):
    """Same records, same RandomState: the same shuffled batches, images
    (PNG patches, flipped ones mirrored) bit-equal, the remainder dropped."""
    images, labels, bbox, lms = chip_smoke.mtcnn_train_batch("rnet", 7, 10)
    lines = []
    for i in range(10):
        cv2.imwrite(str(tmp_path / f"{i}.png"), images[i])
        lines.append(f"{tmp_path / f'{i}.png'} {int(labels[i])} "
                     + " ".join(f"{v:.4f}" for v in np.concatenate([bbox[i], lms[i]])))
    (tmp_path / "anno.txt").write_text("\n".join(lines) + "\n")
    records = mtcnn_data.parse_mtcnn_imdb(str(tmp_path / "anno.txt"))
    imdb = [dict(r, image=r["image"][:-4]) for r in mtcnn_data.append_flipped_images(records)]
    ours = list(mtcnn_data.mtcnn_batches(imdb, 6, rng=np.random.RandomState(seed)))
    theirs = list(jax_data.mtcnn_batches(imdb, 6, rng=np.random.RandomState(seed)))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_assemble_annotations_matches_fdt(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("".join(f"a{i}\n" for i in range(10)))
    b.write_text("".join(f"b{i}\n" for i in range(100)))
    outs = []
    for module in (jax_data, mtcnn_data):
        out = tmp_path / f"{module.__name__}.txt"
        out.write_text("stale\n")
        n = module.assemble_annotations(str(out), [str(a), str(b)], np.random.RandomState(3),
                                        base_num=10)
        outs.append((n, out.read_text()))
    assert outs[0] == outs[1] and outs[0][0] == 40


def test_iou_one_to_many_matches_fdt():
    rng = np.random.RandomState(0)
    boxes = np.sort(rng.rand(50, 4) * 100, axis=-1)[:, [0, 1, 2, 3]]
    boxes[:, 2:] = boxes[:, :2] + rng.rand(50, 2) * 40
    for box in boxes[:5]:
        np.testing.assert_array_equal(mtcnn_data._iou_one_to_many(box, boxes),
                                      jax_data._iou_one_to_many(box, boxes))


def test_imwrite_writes_what_cv2_reads(tmp_path):
    """image_io.imwrite: a PNG cv2 reads back bit-equal, a JPEG (quality 95)
    within 16 levels of the image (measured 13, as cv2's own JPEG) and equal
    to cv2's own JPEG of it once decoded (measured 0)."""
    img = chip_smoke.photo_like(48, 64, 1)
    assert image_io.imwrite(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "x.png")), img)
    image_io.imwrite(str(tmp_path / "x.jpg"), img)
    cv2.imwrite(str(tmp_path / "y.jpg"), img)
    ours, theirs = cv2.imread(str(tmp_path / "x.jpg")), cv2.imread(str(tmp_path / "y.jpg"))
    assert np.abs(ours.astype(int) - img).max() <= 16
    assert np.abs(ours.astype(int) - theirs).max() <= 1
    assert np.abs(image_io.imread(str(tmp_path / "x.jpg")).astype(int) - ours).max() <= 1


def test_resize_patch_within_one_level_of_cv2():
    rng = np.random.RandomState(0)
    for h, w, s in ((37, 41, 12), (12, 12, 24), (90, 64, 48), (200, 180, 12)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ours = mtcnn_data.resize_patch(img, s)
        theirs = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        assert ours.shape == theirs.shape and ours.dtype == np.uint8
        assert np.abs(ours.astype(int) - theirs).max() <= 1
