"""fdt_torch's MTCNN cascade against fdt's with the "gather" crops (fdt's
choice off the TPU), on the CPU at FAST_BUDGETS, for both weight settings:
stage by stage on fdt's own inputs, then the whole cascade
(tests/test_torch_mtcnn.py holds the checks)."""
import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tests.test_torch_mtcnn import SETTINGS, check_cascade, check_stages, frame  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("h,w", [(120, 160), (96, 128)])
def test_stages_fed_fdt_inputs(setting, h, w):
    check_stages(setting, "gather", frame(0, h, w))


@pytest.mark.parametrize("setting", SETTINGS)
def test_whole_cascade(setting):
    check_cascade(setting, "gather")
