"""BENCHMARK.json against the rules a benchmark file keeps."""

import json
import re

from h100_bench import run as harness

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_sizes():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert SPEC["paths"] == ["h100_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(set(names)) == len(names)
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")


def test_files_and_configs():
    for c in SPEC["configs"]:
        assert c["file"].startswith("h100_bench/")
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    for m in SPEC["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer
        for m in layer:
            assert m["moves"] in [e["name"] for e in mine]
