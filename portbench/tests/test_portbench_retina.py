"""The RetinaFace cell (retina.eval) from its files alone: the configuration
picks the `retinaface` family, the mix the `batch_landmarks` kind, beside
the benchmark's own modules, with its limits and the `graph_hit_share`
reader; and the comparison that decides `correct` sees what the rows alone
would not: landmarks shifted by a few pixels, and scores left as logits."""
import json

from portbench import entries, families, harness
from portbench.tests.conftest import REPO, run_tiny

CELL = "retina.eval"


def test_the_cell_loads_from_its_files():
    import torch
    cell = harness.load_cell(REPO, CELL, 2**31 + 5, 1.0, True, torch.device("cpu"), 0.0)
    assert cell.family is families.load("retinaface") and cell.family.SERVICE == "retinaface"
    assert entries.load(cell.traffic["kind"]).__name__ == "portbench.entries.batch_landmarks"
    assert set(cell.limits["limits"]) == {"unmatched_share", "score_gap_mean",
                                          "landmark_gap_mean", "overlapping_kept"}
    names = [m["name"] for m in cell.metrics]
    assert "graph_hit_share" in names and "k1_roofline" in names
    assert [m["name"] for m in cell.end_to_end] == ["images_per_s", "setup_s"]
    conf = json.loads((REPO / "portbench" / "configs" / "retinaface_res50.json").read_text())
    assert conf["reduced"] == [] and conf["dtype"] == "bfloat16"
    assert cell.family.flops_per_image(cell) == 226_635_022_336  # ≈ 113 GMAC at 1024²


class _Run:
    """What graph_hit_share reads of a run record."""

    def __init__(self, stats):
        self.cell = type("Cell", (), {"root": REPO})()
        self.stats = stats


def test_graph_hit_share_reads_the_stretchs_counters():
    def read(stats):
        return harness.read_metric("graph_hit_share", _Run(stats))
    assert read({"graph_replays": 98, "graph_eager": 1, "graph_captures": 1}) == 0.98
    assert read({}) is None  # no counters read: nothing, and no error
    assert read({"graph_replays": 0, "graph_eager": 0, "graph_captures": 0}) is None


def test_counting_trace_gives_the_counters_increase(monkeypatch):
    from portbench.entries import batch_landmarks as bl
    reads = iter([{"graph_captures": 1, "graph_replays": 5, "graph_eager": 1},
                  {"graph_captures": 1, "graph_replays": 95, "graph_eager": 1}])
    monkeypatch.setattr(bl, "_graph_counts", lambda: next(reads))
    monkeypatch.setattr(bl.Trace, "start", lambda self: setattr(self, "_prof", object()))
    monkeypatch.setattr(bl.Trace, "stop", lambda self: setattr(self, "_prof", None))
    t = bl.CountingTrace()
    t.start()
    t.stop()
    t.stop()  # the entry stops a stopped trace again: nothing read
    assert t.graph_stats() == {"graph_captures": 0, "graph_replays": 90, "graph_eager": 0}


def _broken(monkeypatch, change):
    from fdt_torch.infer.pyramidbox import PyramidBoxDetector
    real = PyramidBoxDetector.detect_device

    def broken(self, images_u8, conf_thresh=None, nms_thresh=None):
        return change(real(self, images_u8, conf_thresh, nms_thresh).clone(), images_u8)

    monkeypatch.setattr(PyramidBoxDetector, "detect_device", broken)


def test_the_tiny_cell_is_correct_with_its_landmark_numbers(tiny_root):
    result = run_tiny(tiny_root, CELL)
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == ["unmatched_share", "score_gap_mean",
                                      "landmark_gap_mean", "overlapping_kept", "failed"]
    assert result["notes"]["landmark_rows"] > 0


def test_landmarks_shifted_by_a_few_pixels_are_not_correct(tiny_root, monkeypatch):
    """Every landmark 3 pixels right and down, boxes and scores untouched:
    the rows pass, landmark_gap_mean does not."""
    def shift(out, images):
        h, w = images.shape[1:3]
        out[:, 1:, :, 5::2] += 3.0 / w
        out[:, 1:, :, 6::2] += 3.0 / h
        return out
    _broken(monkeypatch, shift)
    checks = run_tiny(tiny_root, CELL, seconds=1.5)["checks"]
    assert checks["landmark_gap_mean"]["value"] >= checks["landmark_gap_mean"]["limit"], checks
    for name in ("unmatched_share", "score_gap_mean"):
        assert checks[name]["value"] < checks[name]["limit"], checks


def test_scores_left_as_logits_are_not_correct(tiny_root, monkeypatch):
    """The head fed the class logits where the softmax's scores belong."""
    from fdt_torch.infer.detect import ssd_detect
    from fdt_torch.infer.retinaface import RetinaFaceDetector

    def logits_head(self, out, priors, dcfg):
        return ssd_detect(out["face_loc"], out["face_conf"], priors, dcfg, budget=self.budget,
                          extra=out["face_landm"])
    monkeypatch.setattr(RetinaFaceDetector, "_head", logits_head)
    result = run_tiny(tiny_root, CELL, seconds=1.5)
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["score_gap_mean"]["value"] >= checks["score_gap_mean"]["limit"], checks


def test_the_kind_leaves_batch_as_it_was():
    """The kind drives batch.run with two names swapped for the call only."""
    from portbench.entries import batch, batch_landmarks
    before = (batch._rows, batch.tracer)
    assert entries.load("batch_landmarks") is batch_landmarks
    with batch_landmarks._swapped(batch, _rows=None, tracer=None):
        assert batch._rows is None and batch.tracer is None
    assert (batch._rows, batch.tracer) == before
