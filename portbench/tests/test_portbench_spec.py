"""BENCHMARK.json against the contract's shape, and every file it leads to."""
import json
import re

from portbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_shown_keys_and_allowed_characters():
    for group, keys in KEYS.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer"):
                if k in e:
                    assert TEXT.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_metrics_and_cells_fit_together():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in cells:  # setup_s, one more end-to-end metric, one per-layer metric
        assert sum(w in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_every_named_file_exists_under_paths():
    bench = REPO / "portbench"
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and (REPO / conf["weights"]).is_file()
        assert (bench / "families" / f"{conf['family']}.py").is_file()
    for w in BENCH["workloads"]:
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "entries" / f"{mix['kind']}.py").is_file()
        limits = json.loads((bench / "limits" / f"{w['name']}.json").read_text())
        assert set(limits["limits"]) <= {"unmatched_share", "overlapping_kept",
                                         "score_gap_mean", "score_bias"}
    for m in BENCH["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
