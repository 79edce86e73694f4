"""Drive the rest of a run with the timed path broken underneath and see
`correct` come out false, for each fault a detection cell can have: half of
a batch left out (those images answered with nothing), and an answer altered
where it is produced (an image's boxes shrunk; its scores rescaled after the
threshold, which leaves the rows as they were).  A step's
state and an exchange between chips do not exist in these cells."""

import json

import pytest
import torch

from fdt_torch.infer.pyramidbox import PyramidBoxDetector
from portbench.tests.conftest import REPO, run_tiny, tiny_cells

CELLS = tiny_cells()
BENCH_CELLS = {w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]}


class HalfLeftOut:
    """The second half of each batch answered with nothing; of batches of
    one image, every second one."""

    def __init__(self):
        self.singles = 0

    def __call__(self, out):
        n = out.shape[0]
        if n == 1:
            self.singles += 1
            return out * 0 if self.singles % 2 else out
        out[(n + 1) // 2:] = 0
        return out


class AnswerAltered:
    """The first image of each batch answered with every box shrunk to a
    tenth of its width and height about its centre."""

    def __call__(self, out):
        box = out[0, 1, :, 1:5]
        centre, half = (box[:, :2] + box[:, 2:]) / 2, (box[:, 2:] - box[:, :2]) / 20
        out[0, 1, :, 1:5] = torch.cat([centre - half, centre + half], -1)
        return out


class ScoresHalved:
    """Every returned score halved after the threshold: the rows, their
    boxes and their ranking stay as they were."""

    def __call__(self, out):
        out[:, :, :, 0] *= 0.5
        return out


@pytest.mark.parametrize("fault", [HalfLeftOut, AnswerAltered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault, monkeypatch):
    real = PyramidBoxDetector.detect_device
    broken_out = fault()

    def broken(self, images_u8, conf_thresh=None, nms_thresh=None):
        return broken_out(real(self, images_u8, conf_thresh, nms_thresh).clone())

    monkeypatch.setattr(PyramidBoxDetector, "detect_device", broken)
    result = run_tiny(tiny_root, workload, seconds=1.5)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", [w for w in CELLS if w in BENCH_CELLS])
def test_rescaled_scores_are_not_correct(tiny_root, workload, monkeypatch):
    """Scores halved after the threshold keep every row and its box, so the
    rows alone (unmatched_share) pass, and only the scores' own gap to the
    reference's (score_gap_mean, score_bias) can see the fault."""
    real = PyramidBoxDetector.detect_device

    def broken(self, images_u8, conf_thresh=None, nms_thresh=None):
        return ScoresHalved()(real(self, images_u8, conf_thresh, nms_thresh).clone())

    monkeypatch.setattr(PyramidBoxDetector, "detect_device", broken)
    result = run_tiny(tiny_root, workload, seconds=1.5)
    checks = result["checks"]
    assert result["correct"] is False, checks
    assert checks["unmatched_share"]["value"] < checks["unmatched_share"]["limit"], checks
