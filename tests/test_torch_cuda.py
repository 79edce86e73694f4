"""fdt_torch's CUDA kernels against their plain versions, on the card.

This file imports neither jax nor fdt, so it runs on the GPU machine, which
has neither (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Where there is no card every test skips.
"""
import numpy as np
import pytest
import torch

from fdt_torch.geometry import nms
from fdt_torch.ops import nms as nms_op

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _boxes(rng, shape, spread):
    centers = rng.rand(*shape, 2) * spread
    wh = rng.rand(*shape, 2) * 3.0 + 0.5
    return np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_kernel_keep_mask_bit_equal_to_plain(card, mode):
    rng = np.random.RandomState(0)
    boxes = torch.from_numpy(_boxes(rng, (3, 1500), 20.0)).to(card)
    valid = torch.from_numpy(rng.rand(3, 1500) > 0.2).to(card)
    seg = torch.from_numpy((rng.rand(3, 1500) * 5).astype(np.int32)).to(card)
    for seg_id in (None, seg):
        before = nms_op.launches.count
        got = nms_op.nms_keep_tiled(boxes, valid, 0.4, mode=mode, seg_id=seg_id)
        assert nms_op.launches.count == before + 1
        assert torch.equal(got, nms.nms_keep_mask(boxes, valid, 0.4, mode=mode,
                                                  seg_id=seg_id))


def test_nms_padded_on_card_equals_cpu(card):
    """Sort, kernel and compaction on the card give the CPU's indices."""
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, (2, 3, 3000), 60.0)
    scores = (rng.randint(0, 50, (2, 3, 3000)) / 49).astype(np.float32)  # many ties
    args = dict(budget=2500, out_k=300)
    idx_c, cnt_c = nms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.35,
                                  valid=torch.from_numpy(scores > 0.1), **args)
    idx_g, cnt_g = nms.nms_padded(torch.from_numpy(boxes).to(card),
                                  torch.from_numpy(scores).to(card), 0.35,
                                  valid=torch.from_numpy(scores > 0.1).to(card), **args)
    assert torch.equal(cnt_g.cpu(), cnt_c)
    for i, c in np.ndenumerate(cnt_c.numpy()):
        assert torch.equal(idx_g.cpu()[i][:c], idx_c[i][:c])


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    boxes = torch.zeros(2, 10, 4, device=card)
    valid = torch.ones(2, 10, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="float32"):
        nms_op.nms_keep_tiled(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_op.nms_keep_tiled(boxes.transpose(0, 1).contiguous().transpose(0, 1), valid, 0.5)
    with pytest.raises(ValueError, match="int32"):
        nms_op.nms_keep_tiled(boxes, valid, 0.5, seg_id=torch.zeros(2, 10, device=card))


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_greedy_kernel_bit_equal_to_plain_and_k1(card, mode):
    """K2 against its plain version and against K1, with a degenerate
    (zero-area) box whose 0/0 overlaps must suppress nothing."""
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, (3, 2000), 20.0)
    boxes[:, 5] = boxes[:, 5, :2].repeat(2, axis=-1)  # x2 = x1, y2 = y1
    boxes = torch.from_numpy(boxes).to(card)
    valid = torch.from_numpy(rng.rand(3, 2000) > 0.2).to(card)
    valid[:, 1900:] = False  # an extent short of N
    before = nms_op.greedy_launches.count
    got = nms_op.nms_keep_greedy(boxes, valid, 0.4, mode=mode)
    assert nms_op.greedy_launches.count == before + 1
    assert torch.equal(got, nms.nms_keep_mask(boxes, valid, 0.4, mode=mode))
    assert torch.equal(got, nms_op.nms_keep_tiled(boxes, valid, 0.4, mode=mode))


def test_nms_padded_impls_agree_on_card(card):
    """impl="pallas" (K2), "pallas_tiled" (K1), "xla" and "auto" give the same
    indices and counts on the card as on the CPU."""
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, (4, 2048), 50.0)
    scores = rng.rand(4, 2048).astype(np.float32)
    args = dict(budget=2048, out_k=750)
    idx_c, cnt_c = nms.nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                  valid=torch.from_numpy(scores > 0.35), **args)
    for impl in ("pallas", "pallas_tiled", "xla", "auto"):
        idx_g, cnt_g = nms.nms_padded(torch.from_numpy(boxes).to(card),
                                      torch.from_numpy(scores).to(card), 0.5,
                                      valid=torch.from_numpy(scores > 0.35).to(card),
                                      impl=impl, **args)
        assert torch.equal(cnt_g.cpu(), cnt_c), impl
        for i, c in enumerate(cnt_c.tolist()):
            assert torch.equal(idx_g.cpu()[i][:c], idx_c[i][:c]), impl


def test_greedy_wrapper_rejects_more_boxes_than_shared_memory_holds(card):
    boxes = torch.zeros(1, 8193, 4, device=card)
    with pytest.raises(ValueError, match="too large"):
        nms_op.nms_keep_greedy(boxes, torch.ones(1, 8193, dtype=torch.bool, device=card), 0.5)
