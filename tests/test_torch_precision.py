"""The detectors' `precision` (fdt's "highest" | "default"): the forward runs
with TF32 off, or allowed, and the global torch.backends flags come back as
they were, also when the forward raises."""
import numpy as np
import pytest
import torch

from fdt_torch.config import FaceBoxConfig
from fdt_torch.infer import FaceBoxDetector, PyramidBoxDetector

torch.set_num_threads(1)


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _Stop(Exception):
    pass


class _Probe(torch.nn.Module):
    """Records the TF32 flags its forward sees, then stops the call."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(_flags())
        raise _Stop


def _detector(family, **kwargs):
    if family == "pyramidbox":
        return PyramidBoxDetector(_Probe(), device="cpu", **kwargs), np.zeros((1, 64, 64, 3))
    cfg = FaceBoxConfig(input_size=128)
    return FaceBoxDetector(_Probe(), cfg=cfg, device="cpu", **kwargs), np.zeros((1, 128, 128, 3))


@pytest.mark.parametrize("family", ["pyramidbox", "facebox"])
@pytest.mark.parametrize("precision, tf32", [(None, False), ("highest", False),
                                             ("default", True)])
def test_forward_sees_the_precision_and_flags_are_restored(family, precision, tf32):
    det, frames = _detector(family, **({} if precision is None else {"precision": precision}))
    old = _flags()
    try:
        for outside in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = outside
            with pytest.raises(_Stop):
                det.detect_device(torch.from_numpy(frames.astype(np.uint8)))
            assert det.model.seen[-1] == (tf32, tf32)
            assert _flags() == (outside, outside)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("family", ["pyramidbox", "facebox"])
def test_unknown_precision_raises(family):
    with pytest.raises(ValueError, match="precision"):
        _detector(family, precision="high")
