"""The serving and the remaining twins of ``examples/*.py`` on the CPU at a
small size, and the port's committed card artifacts under
``docs/runs_torch/``.

* ``retrieval_1m`` at 2,048 candidates, brute force, IVF and the coarse
  shortlist, and on a one-rank mesh; ``serve_load`` at 2,048 with two
  clients and 16 requests (``--interpret``); the int8 error analysis at
  pools of 1,024 and 2,048 (a subpool of 512); ``pair_image_metric`` at 10 steps;
  ``pycaffe_port`` under ``tmp_path`` (needs h5py).  Each returns the JAX
  script's keys.  Without a card and without a CPU flag each raises.
* ``docs/runs_torch/recipe_full_budget``: two card runs of the recipe's
  40,001 steps, held as the JAX package holds its own artifact, and their
  ``trec_eval`` fields equal to the in-process MAP / MRR;
  ``docs/runs_torch/int8_error_analysis``: the JAX summary's keys.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mms_answer_selection_tpu_torch.examples import (
    int8_error_analysis, pair_image_metric, retrieval_1m, serve_load)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops; one intra-op thread a test keeps the
    tier-1 run's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
RUNS = ROOT / "docs" / "runs_torch"


def test_retrieval_1m_small_with_ivf_and_coarse():
    out = retrieval_1m.main(
        ["--pool", "2048", "--queries", "16", "--ivf-clusters", "16",
         "--nprobe", "16", "--coarse-shortlist", "2048"], device="cpu")
    assert out["pool_dtype"] == "bf16" and out["device"] == "cpu"
    assert len(out["top_k_query0"]) == 10
    # probing every cluster, or shortlisting the whole pool, is exact
    assert out["ivf"]["recall@10"] == 1.0
    assert out["coarse"]["recall@10"] == 1.0


def test_retrieval_1m_on_a_one_rank_mesh_equals_one_process():
    import torch.distributed as dist

    plain = retrieval_1m.main(["--pool", "2048", "--queries", "8"],
                              device="cpu")
    meshed = retrieval_1m.main(["--pool", "2048", "--queries", "8",
                                "--mesh"], device="cpu")
    assert not dist.is_initialized()        # the one-rank group is gone
    assert plain["pool_dtype"] == meshed["pool_dtype"] == "int8"
    assert [i for i, _ in plain["top_k_query0"]] == \
        [i for i, _ in meshed["top_k_query0"]]


def test_serve_load_small_interpret(tmp_path):
    out = serve_load.main(
        ["--pool", "2048", "--clients", "2", "--requests", "16",
         "--interpret", "--json", str(tmp_path / "load.json")])
    assert {"pool", "clients", "requests", "k", "rerank", "pool_dtype",
            "unbatched", "batched", "speedup"} <= set(out)
    for label in ("unbatched", "batched"):
        row = out[label]
        assert set(row) == {"req_per_s", "p50_ms", "p90_ms", "p99_ms",
                            "device_dispatches", "rows_per_dispatch"}
        assert row["device_dispatches"] >= 1
    # unbatched: one request a dispatch (warm-up included)
    assert out["unbatched"]["device_dispatches"] == 16 + 4
    assert json.loads((tmp_path / "load.json").read_text()) == out


def test_int8_error_analysis_small():
    out = int8_error_analysis.error_analysis((1024, 2048), subpool=512,
                                             device="cpu")
    want = set(json.loads((ROOT / "docs/runs/int8_error_analysis/"
                           "summary.json").read_text()))
    want = {k for k in want if not k.startswith("pool_")}
    assert want | {"pool_1024", "pool_2048"} == set(out)
    assert set(out["guidance"]) == {"rule", "S_1k", "S_2k", "S_8k_pred",
                                    "S_20k_pred"}
    err = out["per_pair_error"]
    assert 0 < err["sigma"] < 0.5 and abs(err["mean"]) < 0.05
    for pool in (1024, 2048):
        row = out[f"pool_{pool}"]
        assert 0.5 < row["top10_agreement"] <= 1.0
        assert row["recall10_in_s"]["512"] == 1.0


def test_int8_error_analysis_never_writes_the_jax_artifact():
    dst = Path(int8_error_analysis.OUT_DIR).resolve()
    assert dst == (RUNS / "int8_error_analysis").resolve()


def test_pair_image_metric_ten_steps(tmp_path):
    out = pair_image_metric.main(["--steps", "10", "--dir", str(tmp_path)],
                                 device="cpu")
    assert out["step"] == [0] and np.isfinite(out["final_loss"])
    again = pair_image_metric.main(["--steps", "10", "--dir",
                                    str(tmp_path)], device="cpu")
    assert again["final_loss"] == out["final_loss"]    # seeded


def test_pycaffe_port_tutorial_flow(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    from mms_answer_selection_tpu_torch import caffe_compat
    from mms_answer_selection_tpu_torch.device import set_pycaffe_mode
    from mms_answer_selection_tpu_torch.examples import pycaffe_port

    # the script chooses the card; here the CPU stands in for it
    monkeypatch.setattr(caffe_compat, "set_mode_gpu",
                        caffe_compat.set_mode_cpu)
    try:
        out = pycaffe_port.main([str(tmp_path)])
    finally:
        set_pycaffe_mode("gpu")             # pycaffe's default mode
    assert [it for it, _, _ in out["log"]] == [100, 200, 300, 400, 500]
    assert out["deploy_acc"] > 0.9
    assert Path(out["snapshot"]).exists()


def test_serving_twins_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for call in (lambda: retrieval_1m.main(["--pool", "64"]),
                 lambda: serve_load.main(["--pool", "64"]),
                 lambda: int8_error_analysis.error_analysis((64, 128)),
                 lambda: pair_image_metric.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# --------------------------------------------------------------- artifacts
@pytest.mark.parametrize("name", ["summary.json", "second_run.json"])
def test_full_budget_card_artifact(name):
    """The recipe's 40,001 steps on the card, twice from one seed
    (``docs/runs_torch/recipe_full_budget/README.md``)."""
    s = json.loads((RUNS / "recipe_full_budget" / name).read_text())
    assert s["max_iter"] == 40001
    assert s["early_stop_patience"] == 0
    assert s["last_eval_step"] >= 40000
    assert s["backend"] == "cuda"
    assert s["card"].startswith("NVIDIA") and s["card"].endswith(" W")
    assert s["best_dev_map"] > s["chance_dev_map_step0"] + 0.25
    assert abs(s["test_trec_eval"]["map"] - s["test_map"]) < 1e-9
    assert abs(s["test_trec_eval"]["recip_rank"] - s["test_mrr"]) < 1e-9


def test_full_budget_card_artifact_files():
    """history.json carries the summary's curve; truth / result score to
    the summary's trec_eval fields."""
    from mms_answer_selection_tpu_torch.metrics import trec_eval

    d = RUNS / "recipe_full_budget"
    s = json.loads((d / "summary.json").read_text())
    h = json.loads((d / "history.json").read_text())
    assert len(h["steps"]) == 401 and h["steps"][-1] == 40000
    assert h["dev_map"][0] == s["chance_dev_map_step0"]
    assert max(h["dev_map"]) == s["best_dev_map"]
    assert h["steps"][int(np.argmax(h["dev_map"]))] == s["best_step"]
    ev = trec_eval(str(d / "truth"), str(d / "result"))
    assert abs(ev["map"] - s["test_map"]) < 1e-9
    assert abs(ev["recip_rank"] - s["test_mrr"]) < 1e-9


def test_full_budget_graphs_card_artifact():
    """The recipe's 40,001 steps with each chunk of 50 one CUDA graph
    replay (``docs/runs_torch/recipe_full_budget_graphs/README.md``): every
    chunk the loop plans was a replay, the curve is the summary's, and
    truth / result score to its trec_eval fields."""
    from mms_answer_selection_tpu_torch.metrics import trec_eval
    from mms_answer_selection_tpu_torch.training import Trainer

    d = RUNS / "recipe_full_budget_graphs"
    s = json.loads((d / "summary.json").read_text())
    h = json.loads((d / "history.json").read_text())
    assert s["max_iter"] == 40001 and s["early_stop_patience"] == 0
    assert s["backend"] == "cuda" and s["card"].endswith(" W")
    chunks, it = 0, 0
    while it < s["max_iter"]:
        it += Trainer._plan_chunk(it, 50, s["max_iter"] - it, [100, 1000])
        chunks += 1
    assert s["dispatch"]["graph_replays"] == chunks == 801
    assert sorted(c["k"] for c in s["dispatch"]["captures"]) == [1, 50]
    assert s["best_dev_map"] > s["chance_dev_map_step0"] + 0.25
    assert len(h["steps"]) == 401 and h["steps"][-1] == 40000
    assert max(h["dev_map"]) == s["best_dev_map"]
    assert h["steps"][int(np.argmax(h["dev_map"]))] == s["best_step"]
    ev = trec_eval(str(d / "truth"), str(d / "result"))
    assert abs(ev["map"] - s["test_map"]) < 1e-9
    assert abs(ev["recip_rank"] - s["test_mrr"]) < 1e-9


def test_int8_error_analysis_card_artifact_keys():
    want = json.loads((ROOT / "docs/runs/int8_error_analysis/summary.json")
                      .read_text())
    got = json.loads((RUNS / "int8_error_analysis" / "summary.json")
                     .read_text())
    assert set(got) == set(want) | {"card"}
    assert got["card"].startswith("NVIDIA")
    for key in ("per_pair_error", "pool_262144", "pool_1048576",
                "guidance"):
        assert set(got[key]) == set(want[key]), key


def test_full_budget_eval_graphs_card_artifact():
    """The recipe's 40,001 steps with its chunks and its evals as CUDA
    graph replays (``docs/runs_torch/recipe_full_budget_eval_graphs/
    README.md``): two replays an eval (dev and test) of two graphs, every
    planned chunk a replay, the curve the summary's, and truth / result
    scoring to its trec_eval fields."""
    from mms_answer_selection_tpu_torch.metrics import trec_eval

    d = RUNS / "recipe_full_budget_eval_graphs"
    s = json.loads((d / "summary.json").read_text())
    h = json.loads((d / "history.json").read_text())
    assert s["max_iter"] == 40001 and s["backend"] == "cuda"
    assert s["dispatch"]["graph_replays"] == 801
    assert s["eval_dispatch"]["graph_replays"] == 2 * len(h["steps"]) == 802
    assert len(s["eval_dispatch"]["captures"]) == 2
    assert s["best_dev_map"] > s["chance_dev_map_step0"] + 0.25
    assert max(h["dev_map"]) == s["best_dev_map"]
    assert h["steps"][int(np.argmax(h["dev_map"]))] == s["best_step"]
    ev = trec_eval(str(d / "truth"), str(d / "result"))
    assert abs(ev["map"] - s["test_map"]) < 1e-9
    assert abs(ev["recip_rank"] - s["test_mrr"]) < 1e-9
