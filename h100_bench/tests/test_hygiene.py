"""What the harness loads and reads, how it refuses, and that a cell
added as new files alone is found by name."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from h100_bench import run as harness

from .cells import measure, small_run

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "mms_answer_selection_tpu"}

# every cell's inputs built and a small run of each kind driven on the
# CPU, in a fresh process, with every file opened recorded by an audit
# hook; prints the forbidden top-level modules loaded and the files read
DRIVE = textwrap.dedent("""
    import json, sys
    opened = []
    sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                     if ev == "open" and args and args[0] else None)
    import torch
    torch.set_num_threads(2)
    from h100_bench import control, port, roofline, traffic  # noqa: F401
    from h100_bench.tests.cells import measure, small_run
    from h100_bench import run as harness
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    for cell in spec["workloads"]:
        run = small_run(cell["name"])
        harness.runner(run)
        for m in run.per_layer:
            harness.read_metric(m["name"], run)
        if run.traffic.get("ranks", 1) == 1:
            measure(run)
    print(json.dumps({"modules": harness.forbidden_modules(),
                      "top": sorted({m.split(".")[0] for m in sys.modules}),
                      "opened": opened}))
""")


def drive():
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_no_jax_bench_files():
    rec = drive()
    assert rec["modules"] == []
    assert not FORBIDDEN & set(rec["top"])
    assert "mms_answer_selection_tpu_torch" in rec["top"]
    for path in rec["opened"]:
        name = os.path.basename(path)
        assert name != "bench.py" and not name.startswith("BENCH_"), path
        assert not name.startswith("MULTICHIP_"), path
        rel = os.path.relpath(os.path.abspath(path), ROOT)
        assert not rel.startswith("mms_answer_selection_tpu" + os.sep), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "mms_answer_selection_tpu_torch.x",
                        object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert harness.forbidden_modules() == ["flax"]


def _bench(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "h100_bench", "--workload",
         "v4.query_1m_int8_b256", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_it_refuses_and_prints_no_result():
    out = _bench(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    home = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", home,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.read_json(ROOT / "BENCHMARK.json")
    cfg = json.loads((home / "configs" / "v4.json").read_text())
    cfg["name"] = "v4_again"
    (home / "configs" / "v4_again.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / "query_1m_int8_b256.json")
                     .read_text())
    mix["k"] = 5
    (home / "traffic" / "query_k5.json").write_text(json.dumps(mix))
    (home / "metrics" / "calls.query.py").write_text(
        "def read(run):\n    return float(run.work['calls'])\n")
    spec["configs"].append({"name": "v4_again", "source": "x",
                            "file": "h100_bench/configs/v4_again.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "v4_again.query_k5",
                              "config": "v4_again", "traffic": "query_k5",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "query_pairs_per_s":
            m["workloads"].append("v4_again.query_k5")
    spec["per_layer"].append({"name": "calls.query", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "QueryEngine.query",
                              "moves": "query_pairs_per_s",
                              "workloads": ["v4_again.query_k5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    run = small_run("v4_again.query_k5", root=tmp_path, trace=True)
    assert run.traffic["k"] == 5 and run.config["name"] == "v4_again"
    assert [m["name"] for m in run.end_to_end] == ["query_pairs_per_s",
                                                   "setup_s"]
    assert "calls.query" in [m["name"] for m in run.per_layer]
    assert harness.runner(run).__file__ == str(home / "runners" / "query.py")
    torch.set_num_threads(2)
    measure(run)
    out = harness.result(run, {"platform": "cpu"})
    assert out["metrics"]["calls.query"]["value"] == run.work["calls"]
    assert out["correct"]
    assert list(out)[-1] == "checks"
