"""K1's edge cases (chip_smoke.K1_EDGES) on the CPU: the port's plain keep
mask, which the card holds kernel K1 to bit for bit (tests/test_torch_cuda.py,
chip_smoke.py phase `kernels`), against fdt's Pallas tiled kernel in
interpret mode.  With out_k the Pallas kernel keeps only the first out_k, so
the two agree on each problem's first out_k keeps and the capped mask keeps
nothing that the full one drops (chip_smoke._mask_err)."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fdt.ops.pallas_nms import pallas_nms_keep_tiled  # noqa: E402
from fdt_torch.ops import nms as nms_op  # noqa: E402

torch.set_num_threads(1)

# the 8192-box cases run on the card only: the plain version's [P, N, N]
# overlap temporaries take 0.5 GB each there
CPU_EDGES = [name for name in chip_smoke.K1_EDGES if not name.startswith("n8192")]


@pytest.mark.parametrize("name", CPU_EDGES)
def test_plain_keep_mask_matches_fdt_tiled_kernel(name):
    boxes, valid, seg, mode, thresh, out_k = chip_smoke.k1_edge_case(name)
    ours = nms_op.nms_keep_tiled(torch.from_numpy(boxes), torch.from_numpy(valid), thresh,
                                 mode=mode, seg_id=None if seg is None else torch.from_numpy(seg),
                                 out_k=out_k)
    fdt = np.stack([np.asarray(pallas_nms_keep_tiled(
        jnp.asarray(boxes[p]), jnp.asarray(valid[p]), thresh, mode=mode,
        seg_id=None if seg is None else jnp.asarray(seg[p]), interpret=True, out_k=out_k))
        for p in range(len(boxes))])
    assert chip_smoke._mask_err(torch.from_numpy(fdt), ours, out_k) == 0.0


def test_out_k_cases_end_where_named():
    """The out_k-th keep of each "out_k-at-<i>" case falls on box i."""
    for name in chip_smoke.K1_EDGES:
        if name.startswith("out_k-at-"):
            boxes, valid, _, _, thresh, out_k = chip_smoke.k1_edge_case(name)
            keep = nms_op.nms_keep_tiled(torch.from_numpy(boxes), torch.from_numpy(valid),
                                         thresh)
            assert int(torch.nonzero(keep[0])[out_k - 1]) == int(name.split("-")[2]), name
