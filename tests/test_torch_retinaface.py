"""RetinaFace-ResNet50 in fdt_torch against the benchmark's plain float32
reference (portbench/reference/retinaface.py, which imports nothing of the
port), on its seeded weights in biubug6's state-dict names, at small sizes
on the CPU: the forward, the priors, the detector's rows and landmarks, the
loader's three weight forms, the service, the tracing it adds, and the
shared head, whose PyramidBox path must enqueue what it did before.

The JAX package has no RetinaFace, so the reference is the only oracle.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fdt_torch.anchors import retina_priors  # noqa: E402
from fdt_torch.apps.serving import DetectionService  # noqa: E402
from fdt_torch.config import RETINA_RES50, DetectConfig  # noqa: E402
from fdt_torch.geometry.boxes import decode  # noqa: E402
from fdt_torch.geometry.nms import nms_padded  # noqa: E402
from fdt_torch.infer import detect as detect_mod  # noqa: E402
from fdt_torch.infer import retinaface as retina_mod  # noqa: E402
from fdt_torch.infer.retinaface import RetinaFaceDetector  # noqa: E402
from fdt_torch.models.loader import (load_retinaface, load_retinaface_detector,  # noqa: E402
                                     save_variables_npz, to_jax_variables)
from fdt_torch.utils import trace  # noqa: E402
from portbench.reference import retinaface as ref  # noqa: E402
from portbench.reference.detect import HeadSettings  # noqa: E402

torch.set_num_threads(1)

SEED = 20190502
SIZES = [(2, 96, 128), (1, 100, 72)]  # (batch, height, width); 100 × 72 has odd maps


@pytest.fixture(scope="module")
def state():
    return ref.seeded_state_dict(SEED)


@pytest.fixture(scope="module")
def pth(state, tmp_path_factory):
    path = tmp_path_factory.mktemp("retina") / "Resnet50_seeded.pth"
    torch.save(state, path)
    return str(path)


def frames(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), dtype=np.uint8)


def model_input(images):
    x = torch.from_numpy(images).float() - torch.tensor(ref.PIXEL_MEAN_BGR)
    return x.permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("n,h,w", SIZES)
def test_float32_forward_matches_the_reference(state, pth, n, h, w):
    x = model_input(frames(n, h, w))
    with torch.no_grad():
        out = load_retinaface(pth)(x)
        loc, logits, landm, shapes = ref.RetinaFaceRef(
            {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")})(x)
    assert list(out["source_shapes"]) == shapes == ref.feature_maps(w, h)
    for got, want in ((out["face_loc"], loc), (out["face_conf"], logits),
                      (out["face_landm"], landm)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        # The same float32 operations in the same order on the same CPU
        # kernels (conv, batch_norm, nearest upsampling, cat): equal to a few
        # ulps of the outputs' scale (~1), which a backend choosing another
        # convolution algorithm could still move.
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert float(logits.std()) > 0.3  # seeded heads spread the logits


@pytest.mark.parametrize("h,w", [(96, 128), (100, 72), (1024, 1024)])
def test_priors_equal_the_reference(h, w):
    """ceil(W/step) × ceil(H/step) maps, two min sizes a cell, bit for bit."""
    mine = retina_priors(RETINA_RES50, ref.feature_maps(w, h), w, h)
    assert np.array_equal(mine, ref.priors(ref.feature_maps(w, h), w, h))
    assert len(mine) == 2 * sum(fw * fh for fw, fh in ref.feature_maps(w, h))


@pytest.mark.parametrize("n,h,w", SIZES)
def test_detector_rows_and_landmarks_match_the_reference_head(state, pth, n, h, w):
    """threshold 0.02, top 5000, NMS 0.4, 750 kept, nothing dropped for a
    single candidate: the same rows and landmarks, in pixels."""
    det = load_retinaface_detector(pth, device="cpu")
    images = frames(n, h, w, seed=1)
    out = det.detect_tensor(images, conf_thresh=0.02, nms_thresh=0.4)
    assert out.shape == (n, 2, 750, 15) and not out[:, 0].any()
    results = ref.ReferenceDetector(state)(images, HeadSettings(0.02, 0.4, 5000, 750))
    for d, r in zip(out, results):
        rows = retina_mod.landmark_rows_of(d, 0.02, w, h)
        assert len(rows) == len(r.rows) > 0
        # equal float32 forwards (test above) and the same priors: the
        # same keep set; the decode's rounding in pixels is within 1e-4 px
        np.testing.assert_allclose(rows[:, :5], r.rows, rtol=0, atol=1e-4)
        np.testing.assert_allclose(rows[:, 5:], r.row_landmarks, rtol=0, atol=1e-4)


def test_a_biubug6_state_dict_loads_with_and_without_module_and_as_npz(state, pth, tmp_path):
    """The released checkpoint is saved from DataParallel (`module.` keys);
    a state dict saved without it, and fdt's npz layout, load the same."""
    prefixed = tmp_path / "Resnet50_Final.pth"
    torch.save({f"module.{k}": v for k, v in state.items()}, prefixed)
    npz = tmp_path / "retina.npz"
    save_variables_npz(to_jax_variables(load_retinaface(pth)), str(npz), dtype=np.float32)
    x = model_input(frames(1, 64, 96))
    with torch.no_grad():
        outs = [load_retinaface(str(p))(x) for p in (pth, prefixed, npz)]
    for o in outs[1:]:
        for k in ("face_loc", "face_conf", "face_landm"):
            assert torch.equal(o[k], outs[0][k])
    bad = tmp_path / "bad.pth"
    torch.save({k: v for k, v in state.items() if "LandmarkHead.2" not in k}, bad)
    with pytest.raises(KeyError, match="LandmarkHead.2"):
        load_retinaface(str(bad))


def test_service_returns_rows_with_landmarks(pth):
    det = load_retinaface_detector(pth, device="cpu")
    image = frames(1, 80, 120, seed=3)[0]
    with DetectionService("retinaface", det, frame_size=(120, 80), threshold=0.3) as svc:
        rows = svc.detect(image)
    want = retina_mod.landmark_rows_of(
        det.detect_tensor(image[None], conf_thresh=0.3, nms_thresh=0.35)[0], 0.3, 120, 80)
    assert rows.shape[1] == 15 and len(rows) > 0
    np.testing.assert_array_equal(rows, want)


def test_serve_cli_builds_the_retinaface_service(pth):
    from fdt_torch.cli import serve
    args = serve.build_parser().parse_args(["--detector", "retinaface", "--weights", pth,
                                            "--device", "cpu", "--frame_w", "64",
                                            "--frame_h", "64"])
    svc = serve.build_service(args)
    try:
        assert svc.family == "retinaface" and isinstance(svc.detector, RetinaFaceDetector)
        assert svc.detect(frames(1, 50, 70)[0]).shape[1] == 15
    finally:
        svc.close()


def test_landmark_span_and_rows_counter(pth):
    """Span `detect.landmarks` under `detect.head` on the eager path; the
    counter adds the faces each detect_tensor returned."""
    det = load_retinaface_detector(pth, device="cpu")
    before = retina_mod.landmark_rows.count
    trace.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        out = det.detect_tensor(frames(2, 64, 64), conf_thresh=0.02, nms_thresh=0.4)
    spans = trace.drain().spans
    names = [s.name for s in spans]
    assert names.count("detect.landmarks") == 1
    inner = spans[names.index("detect.landmarks")]
    assert spans[inner.parent].name == "detect.head"
    assert retina_mod.landmark_rows.count - before == int((out[:, 1, :, 0] > 0).sum()) > 0


def _ssd_detect_before(loc, conf, priors, cfg, budget=None):
    """ssd_detect as it was before the per-prior extra was added."""
    b, p, c = conf.shape
    budget = min(budget or cfg.nms_top_k, p)
    boxes = decode(loc, priors, cfg.variance)
    scores = conf[..., 1:].transpose(1, 2)
    boxes = boxes[:, None].expand(b, c - 1, p, 4)
    valid = scores > cfg.conf_thresh
    idx, count = nms_padded(boxes, scores, cfg.nms_thresh, budget=budget,
                            out_k=cfg.top_k, valid=valid)
    if cfg.drop_single_candidate:
        count = torch.where(valid.sum(dim=-1) == 1, 0, count)
    idx = idx.long()
    rows = torch.cat([torch.gather(scores, -1, idx)[..., None],
                      torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))], dim=-1)
    keep = torch.arange(cfg.top_k, device=conf.device) < count[..., None]
    rows = torch.where(keep[..., None], rows, 0.0)
    return torch.cat([rows.new_zeros(b, 1, cfg.top_k, 5), rows], dim=1)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("drop", [True, False])
def test_ssd_detect_without_extra_is_what_it_was(drop):
    """The PyramidBox path (no extra): the same tensor and the same
    operations, in the same order, as before the extra existed."""
    g = torch.Generator().manual_seed(4)
    loc = torch.randn(2, 3000, 4, generator=g)
    conf = torch.softmax(torch.randn(2, 3000, 2, generator=g), -1)
    priors = torch.rand(3000, 4, generator=g) * 0.5 + 0.05
    cfg = DetectConfig(top_k=200, conf_thresh=0.3, nms_thresh=0.35, nms_top_k=1000,
                       drop_single_candidate=drop)
    runs = []
    for fn in (_ssd_detect_before, detect_mod.ssd_detect):
        with _Ops() as ops:
            out = fn(loc, conf, priors, cfg)
        runs.append((out, ops.ops))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) > 10


def test_ssd_detect_decodes_the_extra_for_the_kept_rows_alone():
    g = torch.Generator().manual_seed(5)
    loc, landm = torch.randn(1, 500, 4, generator=g), torch.randn(1, 500, 10, generator=g)
    conf = torch.softmax(torch.randn(1, 500, 2, generator=g), -1)
    priors = torch.rand(500, 4, generator=g) * 0.5 + 0.05
    cfg = RETINA_RES50.detect
    out = detect_mod.ssd_detect(loc, conf, priors, cfg, extra=landm)
    plain = detect_mod.ssd_detect(loc, conf, priors, cfg)
    assert out.shape == (1, 2, 750, 15)
    assert torch.equal(out[..., :5], plain)
    n = int((out[0, 1, :, 0] > 0).sum())
    assert 0 < n < 500 and not out[0, 1, n:].any()
    every = ref.decode_landm(landm[0], priors)  # the reference's decode, every prior
    idx = [int(torch.nonzero((decode(loc[0], priors, cfg.variance) == out[0, 1, i, 1:5])
                             .all(-1))[0]) for i in range(n)]
    torch.testing.assert_close(out[0, 1, :n, 5:], every[idx], rtol=0, atol=0)


def test_int8_and_mesh_stay_on_the_eager_path(pth):
    """int8 (convs quantized from the loaded float32 weights) and a 2-slot
    CPU mesh run the RetinaFace detector eagerly with 15-column rows."""
    from fdt_torch.dist import make_mesh
    from fdt_torch.ops.quant import Int8Conv2d
    images = frames(2, 64, 64, seed=6)
    q = load_retinaface_detector(pth, device="cpu", quant="int8")
    assert any(isinstance(m, Int8Conv2d) for m in q.model.modules())
    assert q.detect_tensor(images).shape == (2, 2, 750, 15)
    plain = load_retinaface_detector(pth, device="cpu").detect_tensor(images)
    meshed = load_retinaface_detector(pth, mesh=make_mesh(devices=["cpu"] * 2))
    # one image a shard against two a batch: the same arithmetic, up to the
    # convolution algorithm the CPU picks for the batch size
    np.testing.assert_allclose(meshed.detect_tensor(images), plain, rtol=0, atol=1e-5)
