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
