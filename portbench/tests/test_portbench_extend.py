"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and BENCHMARK.json entries run without a change to any harness file;
so do a traffic kind and a model family added as modules of their own."""
import hashlib
import json

from portbench.tests.conftest import REPO, run_tiny


def _harness_digest():
    files = sorted(p for p in (REPO / "portbench").rglob("*.py") if "tests" not in p.parts)
    return hashlib.sha256(b"".join(p.read_bytes() for p in files)).hexdigest()


def test_new_cell_from_files_alone(tiny_root):
    before = _harness_digest()
    pb = tiny_root / "portbench"
    conf = json.loads((pb / "configs" / "pyramidbox_try1.json").read_text())
    conf.update(name="pyramidbox_try1_f32", dtype="float32")
    (pb / "configs" / "pyramidbox_try1_f32.json").write_text(json.dumps(conf))
    (pb / "traffic" / "tiny_square.json").write_text(json.dumps({
        "kind": "batch", "width": 48, "height": 48, "batch": 3, "distinct_batches": 2,
        "threshold": 0.2, "nms_thresh": 0.4, "check_batches": 2}))
    (pb / "metrics" / "extra.frames_checked.py").write_text(
        "def read(run):\n    return float(run.cell.traffic['batch'])\n")
    (pb / "limits" / "try1f32.square.json").write_text(json.dumps({
        "limits": {"score_gap": 1e-3, "overlapping_kept": 0}}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pyramidbox_try1_f32", "source": "https://example.org",
                             "file": "portbench/configs/pyramidbox_try1_f32.json",
                             "reduced": [], "why": "float32"})
    bench["workloads"].append({"name": "try1f32.square", "config": "pyramidbox_try1_f32",
                               "traffic": "tiny_square", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("try1f32.square")
    bench["per_layer"].append({"name": "extra.frames_checked", "unit": "images",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "images_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = run_tiny(tiny_root, "try1f32.square")
    assert plain["correct"] and set(plain["metrics"]) == {"images_per_s", "setup_s"}
    assert list(plain["checks"]) == ["score_gap", "overlapping_kept", "failed"]
    traced = run_tiny(tiny_root, "try1f32.square", trace=True)
    assert traced["metrics"] == {"extra.frames_checked": {"value": 3.0, "unit": "images"}}
    # a metric with no "workloads" key reaches every cell that reports what it moves
    assert "extra.frames_checked" in run_tiny(tiny_root, "res50.eval", trace=True)["metrics"]
    assert _harness_digest() == before


def test_new_kind_and_family_from_modules_alone(tiny_root, monkeypatch):
    """A traffic kind (portbench/entries/<kind>.py) and a model family
    (portbench/families/<family>.py) found by the names a mix and a
    configuration give, beside the benchmark's own modules."""
    from portbench import entries, families

    before = _harness_digest()
    pb = tiny_root / "portbench"
    for package, name, body in (
            (entries, "every_other", "from portbench.entries.batch import run  # noqa: F401\n"),
            (families, "pyramidbox_alias", "from portbench.families.pyramidbox import *  # noqa\n")):
        where = pb / package.__name__.split(".")[-1]
        where.mkdir(exist_ok=True)
        (where / f"{name}.py").write_text(body)
        monkeypatch.setattr(package, "__path__", [*package.__path__, str(where)])
    conf = json.loads((pb / "configs" / "pyramidbox_try1.json").read_text())
    conf.update(name="try1_alias", family="pyramidbox_alias")
    (pb / "configs" / "try1_alias.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "batch32_640.json").read_text())
    mix.update(kind="every_other")
    (pb / "traffic" / "every_other.json").write_text(json.dumps(mix))
    (pb / "limits" / "alias.other.json").write_text((pb / "limits" / "try1.batch.json").read_text())
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "try1_alias", "source": "https://example.org",
                             "file": "portbench/configs/try1_alias.json", "reduced": [],
                             "why": "alias"})
    bench["workloads"].append({"name": "alias.other", "config": "try1_alias",
                               "traffic": "every_other", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("alias.other")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    result = run_tiny(tiny_root, "alias.other")
    assert result["correct"] and set(result["metrics"]) == {"images_per_s", "setup_s"}
    assert _harness_digest() == before
