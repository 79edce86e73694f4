"""fdt_torch's data-parallel inference (mesh=) against the unsharded
detector and against fdt's detectors on fdt.dist.make_mesh(2).

A 2-slot CPU mesh (make_mesh(devices=[cpu] * 2), as fdt's tests use virtual
CPU devices) and a batch of 3, so that the padding path runs (the last row
repeated to 4, then cut back).  Tolerances:
  * against the unsharded port detector, fdt's own DP tolerances:
    __graft_entry__.py's rtol 1e-3, atol 2e-4 for PyramidBox and
    tests/test_dist.py's rtol 1e-5, atol 1e-6 for FaceBoxes (a shard's batch
    may take other convolution algorithms than the whole batch's on a
    card; on the CPU the answers came out equal);
  * against fdt's meshed detector, the cross-library tolerances the port's
    detectors are held to (tests/test_torch_mobile.py's try3 and
    tests/test_torch_facebox.py's FaceBoxes: equal counts, rows within 1e-5).
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.config import FaceBoxConfig as JaxFaceBoxConfig  # noqa: E402
from fdt.dist import make_mesh as jax_make_mesh  # noqa: E402
from fdt.infer.facebox import FaceBoxDetector as JaxFaceBoxDetector  # noqa: E402
from fdt.infer.pyramidbox import PyramidBoxDetector as JaxDetector  # noqa: E402
from fdt.models.facebox import FaceBox as JaxFaceBox  # noqa: E402
from fdt.models.pyramidbox_mobile import build_pyramidbox as jax_build  # noqa: E402
from fdt_torch.config import FaceBoxConfig  # noqa: E402
from fdt_torch.dist import make_mesh  # noqa: E402
from fdt_torch.infer import FaceBoxDetector  # noqa: E402
from fdt_torch.models import FaceBox, from_jax_variables, load_pyramidbox_detector  # noqa: E402
from fdt_torch.models.loader import load_npz  # noqa: E402
from tests.test_torch_seeded import nest_like  # noqa: E402

torch.set_num_threads(1)

CPU2 = [torch.device("cpu")] * 2
TRY3 = str(REPO / chip_smoke.VARIANT_WEIGHTS["try3"])
SMALL = dict(input_size=128, feature_map_sizes=(4, 2, 1))
PYRAMID_DP = dict(rtol=1e-3, atol=2e-4)   # __graft_entry__.py:122
FACEBOX_DP = dict(rtol=1e-5, atol=1e-6)   # tests/test_dist.py:179-180
CROSS = dict(rtol=0, atol=1e-5)


def frames(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_pyramid_dp_matches_unsharded_and_fdts_mesh():
    det = load_pyramidbox_detector("try3", TRY3, device="cpu")
    det_dp = load_pyramidbox_detector("try3", TRY3, mesh=make_mesh(devices=CPU2))
    assert det_dp.device == torch.device("cpu") and det_dp.mesh.size == 2
    images = frames(3, 128, 3)
    want = det.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    got = det_dp.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    assert got.shape == want.shape == (3, 2, 750, 5)
    np.testing.assert_allclose(got, want, **PYRAMID_DP)
    jdet = JaxDetector(load_npz(TRY3), jax_build("try3"), "try3", precision="highest",
                       mesh=jax_make_mesh(2))
    theirs = jdet.detect_tensor(images, conf_thresh=0.05, nms_thresh=0.35)
    counts = (got[..., 0] > 0).sum(-1)
    np.testing.assert_array_equal(counts, (theirs[..., 0] > 0).sum(-1))
    assert counts[:, 1].min() > 20
    np.testing.assert_allclose(got, theirs, **CROSS)


def test_pyramid_dp_int8_quantizes_each_shard_on_its_own():
    """quant="int8" replicates the quantized copy (its packed weights) to
    every slot.  An activation's int8 scale is the amax of the tensor it
    quantizes, which on a mesh is the shard's: a meshed int8 detector
    answers as the unsharded one does on each shard's rows (fdt's SPMD graph
    takes the amax over the global batch: a divergence, ROADMAP Queue 3).
    A batch of 1 pads to the mesh and comes back as one row."""
    det = load_pyramidbox_detector("try3", TRY3, device="cpu", quant="int8")
    det_dp = load_pyramidbox_detector("try3", TRY3, quant="int8",
                                      mesh=make_mesh(devices=CPU2))
    images = frames(3, 128, 7)
    got = det_dp.detect_tensor(images, conf_thresh=0.05)
    shards = [det.detect_tensor(images[:2], conf_thresh=0.05),
              det.detect_tensor(images[[2, 2]], conf_thresh=0.05)]
    np.testing.assert_array_equal(got, np.concatenate(shards)[:3])
    whole = det.detect_tensor(images, conf_thresh=0.05)
    assert np.abs(got - whole).max() > 1e-3  # the batch's amax is not the shards'
    one = frames(1, 128, 5)
    np.testing.assert_array_equal(det_dp.detect_tensor(one, conf_thresh=0.05),
                                  det.detect_tensor(one[[0, 0]], conf_thresh=0.05)[:1])


@pytest.fixture(scope="module")
def facebox_flat():
    return chip_smoke.seeded_variables(FaceBox(), chip_smoke.FACEBOX_WEIGHTS_SEED)


def test_facebox_dp_matches_unsharded_and_fdts_mesh(facebox_flat):
    def detector(**kw):
        model = FaceBox()
        model.load_state_dict(from_jax_variables(facebox_flat), strict=True)
        return FaceBoxDetector(model, cfg=FaceBoxConfig(**SMALL), budget=300, out_k=120, **kw)

    det, det_dp = detector(device="cpu"), detector(mesh=make_mesh(devices=CPU2))
    images = frames(3, 128, 6)
    want, got = det.detect_batch(images), det_dp.detect_batch(images)
    variables = nest_like(facebox_flat, JaxFaceBox(), 128)
    jdet = JaxFaceBoxDetector(variables, cfg=JaxFaceBoxConfig(**SMALL), budget=300, out_k=120,
                              precision="highest", stem_impl="direct", mesh=jax_make_mesh(2))
    theirs = jdet.detect_batch(images)
    assert len(got) == len(want) == len(theirs) == 3
    for (b, s), (wb, ws), (tb, tsc) in zip(got, want, theirs):
        assert len(s) == len(ws) == len(tsc) > 10
        np.testing.assert_allclose(b, wb, **FACEBOX_DP)
        np.testing.assert_allclose(s, ws, **FACEBOX_DP)
        np.testing.assert_allclose(b, tb, **CROSS)
        np.testing.assert_allclose(s, tsc, **CROSS)
    boxes, probs = det_dp.candidates(torch.from_numpy(images))
    assert boxes.shape[0] == probs.shape[0] == 3


def test_detector_device_must_be_the_mesh_s_first():
    mesh = make_mesh(devices=CPU2)
    with pytest.raises(ValueError, match="mesh's first device"):
        load_pyramidbox_detector("try3", TRY3, device="meta", mesh=mesh)
