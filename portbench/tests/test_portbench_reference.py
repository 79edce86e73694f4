"""The plain reference held to the port at a small size on the CPU, and the
metric arithmetic held to hand counts and brute force."""
import numpy as np
import pytest
import torch

from portbench.metrics._pairs import k1_bound_s, overlap, pairs_needed
from portbench.metrics._peaks import OPS_PER_S, bound_s
from portbench.reference.detect import HeadSettings, ReferenceDetector, greedy_nms
from portbench.reference.pyramidbox import conv_flops, weight_shapes
from portbench.tests.conftest import REPO

WEIGHTS = {"repo": REPO / "net_weight" / "repo_mini.npz",
           "try1": REPO / "net_weight" / "try1_distilled_mini.npz"}


@pytest.mark.parametrize("variant", ["try1", "repo"])
def test_reference_matches_the_port_in_float32(variant):
    from fdt_torch.models.loader import load_pyramidbox_detector

    ref = ReferenceDetector(str(WEIGHTS[variant]), variant)
    det = load_pyramidbox_detector(variant, str(WEIGHTS[variant]), device="cpu")
    frames = np.random.default_rng(3).integers(0, 256, (2, 72, 104, 3), dtype=np.uint8)
    x = (torch.from_numpy(frames).float() - torch.tensor([104.0, 117.0, 123.0]))
    x = x.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want = det.model(x)
        loc, logits, shapes = ref.net(x)
    assert tuple(shapes) == tuple(want["source_shapes"])
    assert torch.allclose(loc, want["face_loc"], atol=1e-4, rtol=1e-4)
    assert torch.allclose(logits, want["face_conf"], atol=1e-4, rtol=1e-4)
    head = HeadSettings(0.05, 0.35, 5000, 750)
    got = ref(frames, head)
    det_rows = det.detect_tensor(frames, conf_thresh=0.05, nms_thresh=0.35)
    for r, d in zip(got, det_rows):
        n = int((d[1, :, 0] > 0).sum())
        assert n == len(r.rows) > 0
        assert np.allclose(d[1, :n, 0], r.rows[:, 4], atol=1e-5)
        assert np.allclose(d[1, :n, 1:5] * [104, 72, 104, 72], r.rows[:, :4], atol=1e-2)


def test_conv_flops_match_the_hand_count():
    # the flagship at 640²: 111 convolutions, 2.36 T operations a batch of 8
    flops = conv_flops("repo", weight_shapes(str(WEIGHTS["repo"])), 640, 640)
    assert abs(flops / 1e9 - 295.2) < 0.5
    assert conv_flops("repo", weight_shapes(str(WEIGHTS["repo"])), 320, 320) < flops / 3.5
    assert 0 < conv_flops("try1", weight_shapes(str(WEIGHTS["try1"])), 640, 640) < flops


def _brute_pairs(boxes, valid, thresh, out_k):
    """The greedy walk itself, counting each test it makes."""
    kept, tests = [], 0
    iou = overlap(torch.as_tensor(boxes)).numpy()
    for i in range(len(boxes)):
        if not valid[i]:
            continue
        if len(kept) == out_k:
            break
        suppressed = False
        for j in kept:
            tests += 1
            if iou[j, i] >= np.float32(thresh):
                suppressed = True
                break
        if not suppressed:
            kept.append(i)
    return tests


@pytest.mark.parametrize("seed,n,out_k", [(0, 40, 750), (1, 200, 750), (2, 200, 5), (3, 1, 3)])
def test_pairs_needed_matches_brute_force(seed, n, out_k):
    rng = np.random.default_rng(seed)
    c = rng.random((n, 2)) * 5
    wh = rng.random((n, 2)) * 2 + 0.3
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    valid = rng.random(n) > 0.2
    keep = greedy_nms(boxes, valid, 0.35, 10**9)
    got = pairs_needed(torch.as_tensor(boxes), torch.as_tensor(valid), torch.as_tensor(keep),
                       0.35, out_k)
    assert got == _brute_pairs(boxes, valid, 0.35, out_k)


def test_peaks_and_bounds():
    assert OPS_PER_S["bfloat16"] == 989e12 and OPS_PER_S["float32"] == 67e12
    assert bound_s(67e12, "float32", 0) == pytest.approx(1.0)
    assert bound_s(0, "float32", 3.35e12) == pytest.approx(1.0)
    # K1 on the flagship's batch: 2,253,309 tests needed → 0.000437 ms by operations
    assert k1_bound_s(2253309, 8 * 5000) * 1e3 == pytest.approx(0.000437, rel=1e-2)
