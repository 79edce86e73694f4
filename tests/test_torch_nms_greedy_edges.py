"""K2's edge cases (chip_smoke.K2_EDGES) on the CPU: the port's plain keep
mask, which the card holds kernel K2 to bit for bit (tests/test_torch_cuda.py,
chip_smoke.py phase `kernels_k2`), against fdt's per-box Pallas kernel
pallas_nms_keep in interpret mode; that the cases hold what their names say;
and chip_smoke's count of the pair tests K2 computes, on a case worked by
hand."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.ops.pallas_nms import pallas_nms_keep  # noqa: E402
from fdt_torch.ops import nms as nms_op  # noqa: E402

torch.set_num_threads(1)

# the 8192-box case runs on the card only: the plain version's [P, N, N]
# overlap temporaries take 0.5 GB each there
CPU_EDGES = [name for name in chip_smoke.K2_EDGES if name != "n8192"]


def _plain(name):
    boxes, valid, mode, thresh = chip_smoke.k2_edge_case(name)
    before = nms_op.greedy_launches.count
    keep = nms_op.nms_keep_greedy(torch.from_numpy(boxes), torch.from_numpy(valid), thresh,
                                  mode=mode)
    assert nms_op.greedy_launches.count == before  # the plain version: no launch
    return boxes, valid, mode, thresh, keep.numpy()


@pytest.mark.parametrize("name", CPU_EDGES)
def test_plain_keep_mask_matches_fdt_greedy_kernel(name):
    boxes, valid, mode, thresh, ours = _plain(name)
    fdt = np.stack([np.asarray(pallas_nms_keep(jnp.asarray(boxes[p]), jnp.asarray(valid[p]),
                                               thresh, mode=mode, interpret=True))
                    for p in range(len(boxes))])
    np.testing.assert_array_equal(ours, fdt)


@pytest.mark.parametrize("mode", ["union", "minimum"])
def test_chain_across_owners_keeps_every_other_link(mode):
    """Each odd chain box is suppressed by the even one before it, in the
    word before its own, and so suppresses nothing: the next stays kept."""
    boxes, _, _, _, keep = _plain(f"chain-across-owners-{mode}")
    chain = boxes[..., 1] == 0.0  # the other boxes lie near (100, 100)
    for p in range(len(boxes)):
        links = np.nonzero(chain[p])[0]
        assert len(links) == chip_smoke.CHAIN_WORDS
        assert sorted(set(links // 64)) == list(range(chip_smoke.CHAIN_WORDS))
        np.testing.assert_array_equal(keep[p, links], np.arange(len(links)) % 2 == 0)


def test_cases_hold_what_their_names_say():
    assert _plain("no-overlaps")[4].all()
    _, valid, _, _, keep = _plain("identical")
    for p in range(len(keep)):
        assert np.nonzero(keep[p])[0].tolist() == [int(np.argmax(valid[p]))]
    _, valid, _, _, keep = _plain("extent-mid-word")
    assert [int(np.nonzero(v)[0][-1]) for v in valid] == [699, 332]
    _, valid, _, _, keep = _plain("last-valid-only")
    assert np.nonzero(keep)[1].tolist() == [999, 999]
    assert not _plain("no-valid")[4].any()
    _, valid, _, _, keep = _plain("thresh-zero")
    assert keep.sum(-1).tolist() == [1, 1]
    boxes, valid, _, _ = chip_smoke.k2_edge_case("p64")
    assert boxes.shape[0] == 64


def test_k2_pairs_computed_on_a_case_worked_by_hand():
    """130 disjoint boxes (3 words), all valid but box 5: every box is kept.
    Hit words: C(63, 2) + C(64, 2) + C(2, 2) pairs; the push of word 0 (63
    keeps) tests the 66 boxes of words 1 and 2, that of word 1 (64 keeps)
    the 2 of word 2."""
    n = 130
    x = np.arange(n, dtype=np.float32) * 2
    boxes = torch.from_numpy(np.stack([x, x * 0, x + 1, x * 0 + 1], -1))[None]
    valid = torch.ones(1, n, dtype=torch.bool)
    valid[0, 5] = False
    keep = nms_op.nms_keep_greedy(boxes, valid, 0.5)
    assert torch.equal(keep, valid)
    want = 63 * 62 // 2 + 64 * 63 // 2 + 1 + 63 * 66 + 64 * 2
    assert chip_smoke._k2_pairs_computed(boxes, valid, keep, 0.5) == want
    # box 70 (word 1), now on kept box 3, is still tested by the push of
    # word 0 and stays in word 1's hit words (those of valid boxes), but it
    # is no keep of word 1: the push of word 1 tests 63 keeps, not 64
    boxes[0, 70] = boxes[0, 3]
    keep = nms_op.nms_keep_greedy(boxes, valid, 0.5)
    assert not keep[0, 70]
    assert chip_smoke._k2_pairs_computed(boxes, valid, keep, 0.5) == want - 2
