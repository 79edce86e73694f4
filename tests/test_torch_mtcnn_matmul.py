"""fdt_torch's MTCNN cascade against fdt's with the "matmul" crops (per-crop
interpolation matrices, fdt's choice on the TPU), on the CPU at
FAST_BUDGETS, for both weight settings: stage by stage on fdt's own inputs,
then the whole cascade (tests/test_torch_mtcnn.py holds the checks).

fdt's compiled contraction sums the two taps of a crop pixel with one
rounding at some image heights and two at others (XLA's CPU dot fuses the
multiply-add at 96 rows, not at 120), so its crops flip a gray level
against any fixed arithmetic at 96×128 and at none at 120×160.  The port's
matmul computes each tap's product exactly once and adds the two (the sums
at 120×160).  So the crops are held to CROP_FLIPS, and the whole cascade to
the golden's tolerances, which a flip stays inside; the nets, on fdt's own
crops, and every NMS keep set stay exact, and at 120×160 the cascade meets
the gather file's 1e-5 / 1e-3 too.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tests.test_torch_mtcnn import (SETTINGS, assert_rows_match, check_cascade,  # noqa: E402
                                    check_stages, fdt_cascade, frame, port_cascade)

torch.set_num_threads(1)

CROP_FLIPS = 1e-3
SCORE_TOL, PX_TOL = chip_smoke.GOLDEN_TOL, chip_smoke.MTCNN_PX_TOL


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("h,w", [(120, 160), (96, 128)])
def test_stages_fed_fdt_inputs(setting, h, w):
    check_stages(setting, "matmul", frame(0, h, w), flips=CROP_FLIPS)


@pytest.mark.parametrize("setting", SETTINGS)
def test_whole_cascade(setting):
    check_cascade(setting, "matmul", score_tol=SCORE_TOL, px_tol=PX_TOL)


@pytest.mark.parametrize("setting", SETTINGS)
def test_batch_at_120x160_meets_the_gather_tolerances(setting):
    jc, port = fdt_cascade(setting, "matmul"), port_cascade(setting, "matmul")
    images = np.stack([frame(s, 120, 160) for s in (1, 2)])
    want, got = jc.detect_batch(images), port.detect_batch(images)
    np.testing.assert_array_equal(got[2], want[2])
    for i, c in enumerate(want[2]):
        assert_rows_match(got[0][i, :c], got[1][i, :c], want[0][i, :c], want[1][i, :c])
