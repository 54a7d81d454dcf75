"""The port's subpackage exports, the recipe's corpus and the training
twins of ``examples/*.py`` (``mms_answer_selection_tpu_torch/examples``).

* Every name the JAX package's subpackage ``__init__`` exports imports
  from the port's matching subpackage; the ``*_jax`` metrics are the
  port's ``*_torch`` (its idiom).
* The recipe twin builds the corpus the JAX script builds: every array and
  the vocabulary info equal on the same seed and flags (plain, ``--hard``,
  ``--format wikiqa``).
* The recipe and ``trec_qa_mms`` twins run on the CPU at a small size,
  hold their own parity asserts (in-graph MAP / MRR = numpy to 1e-5 =
  ``trec_eval`` to 1e-9) and return the JAX script's keys.  Without a
  card and without a CPU flag an entry point raises.

The numbers rest on the modules' own parity tests (``fit`` against JAX's
``Trainer`` in ``test_torch_training.py``, the metrics in
``test_torch_metrics.py``); these tests check the scripts around them.
"""

import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import data as JD
from mms_answer_selection_tpu.data import wikiqa as JW
from mms_answer_selection_tpu.data.trec_qa import parse_trec_xml
from mms_answer_selection_tpu_torch.examples import recipe_scale_rehearsal
from mms_answer_selection_tpu_torch.examples import trec_qa_mms

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops; one intra-op thread a test keeps the
    tier-1 run's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (subpackage, name): the names the JAX package's __init__ exports that the
# port's lacked
EXPORTS = [
    ("serve", "IVFIndex"), ("serve", "ivf_recall"),
    ("ops", "pool2d_padded"), ("ops", "spatial_pyramid_pool"),
    ("ops", "stochastic_pool2d"),
    ("training", "save_checkpoint"), ("training", "load_checkpoint"),
    ("training", "latest_checkpoint"),
    ("models", "GraphNet"), ("models", "register_layer"), ("models", "Net"),
    ("models", "Classifier"), ("models", "Detector"), ("models", "Solver"),
    ("models", "SGDSolver"), ("models", "NesterovSolver"),
    ("models", "AdaGradSolver"), ("models", "RMSPropSolver"),
    ("models", "AdaDeltaSolver"), ("models", "AdamSolver"),
    ("models", "get_solver"),
    ("utils", "fillers"),
]

JAX_METRICS = ["mean_reciprocal_rank_jax", "mean_reciprocal_rank_jax_sorted",
               "mean_average_precision_jax",
               "mean_average_precision_jax_sorted", "auc_jax",
               "auc_jax_sorted", "rank_accuracy_jax"]

# the keys the JAX script's summary.json carries (its newest artifact)
RECIPE_KEYS = set(json.loads(
    (ROOT / "docs/runs/recipe_scale_wikiqa/summary.json").read_text()))


@pytest.mark.parametrize("sub,name", EXPORTS)
def test_subpackage_exports_the_jax_name(sub, name):
    port = importlib.import_module(f"mms_answer_selection_tpu_torch.{sub}")
    jax_side = importlib.import_module(f"mms_answer_selection_tpu.{sub}")
    assert hasattr(jax_side, name)
    obj = getattr(port, name)
    if name == "fillers":
        assert obj.__name__ == "mms_answer_selection_tpu_torch.utils.fillers"
    else:
        assert obj.__module__.startswith(f"mms_answer_selection_tpu_torch."
                                         f"{sub}")


def test_every_jax_export_is_in_the_port():
    """No subpackage's JAX export is missing but the ``*_jax`` metrics."""
    for sub in ("serve", "ops", "training", "models", "utils", "metrics",
                "data"):
        jax_side = importlib.import_module(f"mms_answer_selection_tpu.{sub}")
        port = importlib.import_module(f"mms_answer_selection_tpu_torch."
                                       f"{sub}")
        public = {n for n in vars(jax_side) if not n.startswith("_")
                  and not isinstance(getattr(jax_side, n), type(os))
                  or n == "fillers"}
        missing = {n for n in public if not hasattr(port, n)}
        assert missing <= set(JAX_METRICS), (sub, missing)


@pytest.mark.parametrize("name", JAX_METRICS)
def test_jax_metrics_are_the_ports_torch_metrics(name):
    from mms_answer_selection_tpu_torch import metrics
    assert callable(getattr(metrics, name.replace("_jax", "_torch")))
    assert not hasattr(metrics, name)


def test_subpackages_import_in_any_order():
    """``models`` exports the pycaffe classes, which reach ``training``,
    which imports ``models``: each subpackage imports first in a fresh
    process."""
    import subprocess
    import sys
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = {sub: subprocess.Popen(
        [sys.executable, "-c", f"import mms_answer_selection_tpu_torch.{sub}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
        for sub in ("training", "models", "parallel", "data", "serve",
                    "examples.recipe_scale_rehearsal")}
    for sub, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (sub, err[-2000:])


# ------------------------------------------------------------------ corpus
SMALL = ["--train-q", "20", "--dev-q", "6", "--test-q", "6"]


def _jax_corpus(args, dim):
    """The corpus exactly as examples/recipe_scale_rehearsal.py builds it
    through the JAX package."""
    world = JD.synthetic_world(vocab_words=args.vocab_words,
                               n_topics=args.topics, dim=dim, seed=args.seed)
    hard = dict(weak_pos_frac=0.35, weak_topic_rate=0.12,
                distractor_frac=0.30, distractor_topic_rate=0.30) \
        if args.hard else {}
    wiki = dict(pos_frac=0.15, all_neg_frac=0.5) \
        if args.format == "wikiqa" else {}

    def split(n_q, lo, hi, seed):
        if args.format == "wikiqa":
            lo, hi = 8, 12
        return JD.synthetic_split(world, n_q, lo, hi, seed=seed, **hard,
                                  **wiki)

    train_xml = split(args.train_q, 30, 50, 101)
    dev_xml = split(args.dev_q, 12, 24, 202)
    test_xml = split(args.test_q, 15, 29, 303)
    if args.format != "wikiqa":
        return JD.prepare_trec_qa(train_xml, dev_xml, test_xml,
                                  world["w2v"])

    def to_tsv(xml):
        qids, qs, ans, labels = parse_trec_xml(xml)
        rows = ["QuestionID\tQuestion\tDocumentID\tDocumentTitle"
                "\tSentenceID\tSentence\tLabel"]
        for i, (qid, q, a, lab) in enumerate(zip(qids, qs, ans, labels)):
            rows.append(f"Q{qid}\t{' '.join(q)}\tD{qid}\ttitle"
                        f"\tD{qid}-{i}\t{' '.join(a)}\t{lab}")
        return "\n".join(rows) + "\n"

    return JW.prepare_wikiqa(to_tsv(train_xml), to_tsv(dev_xml),
                             to_tsv(test_xml), world["w2v"])


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


@pytest.mark.parametrize("extra", [[], ["--hard"], ["--format", "wikiqa"]],
                         ids=["plain", "hard", "wikiqa"])
def test_recipe_corpus_equals_the_jax_scripts(extra):
    args = recipe_scale_rehearsal.parse_args(SMALL + extra)
    splits, info = recipe_scale_rehearsal.build_corpus(args, 50)
    j_splits, j_info = _jax_corpus(args, 50)
    assert len(splits["train"]["label"]) > 100
    _equal(splits, j_splits)
    _equal(info, j_info)


def test_recorded_wikiqa_corpus_is_the_jax_scripts():
    """The card run ``docs/runs_torch/recipe_scale_wikiqa`` trained on the
    corpus the JAX script builds with ``--format wikiqa`` (its pair counts
    and vocabulary), which is not the corpus the JAX package's own
    artifact records: that one was made from sizes its summary omits."""
    args = recipe_scale_rehearsal.parse_args(["--format", "wikiqa"])
    splits, info = _jax_corpus(args, 50)
    want = {k: int(len(v["label"])) for k, v in splits.items()}
    got = json.loads((ROOT / "docs/runs_torch/recipe_scale_wikiqa/"
                      "summary.json").read_text())
    assert got["corpus"] == want
    assert got["vocab_size"] == info["vocab_size"]
    jax_run = json.loads((ROOT / "docs/runs/recipe_scale_wikiqa/"
                          "summary.json").read_text())
    assert jax_run["corpus"] != want


# ------------------------------------------------------------------ twins
def test_recipe_twin_on_the_cpu(tmp_path):
    summary = recipe_scale_rehearsal.main(
        SMALL + ["--hard", "--cpu", "--max-iter", "21", "--min-gain", "0",
                 "--test-interval", "10", "--snapshot-interval", "10",
                 "--fused-steps", "5", "--out", str(tmp_path)])
    assert RECIPE_KEYS <= set(summary)
    assert summary["backend"] == "cpu" and summary["card"] is None
    assert summary["last_eval_step"] == 20 and summary["max_iter"] == 21
    # the artifacts the JAX script writes, and the saved summary
    for name in ("summary.json", "history.json", "truth", "result"):
        assert (tmp_path / name).exists(), name
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    hist = json.loads((tmp_path / "history.json").read_text())
    assert hist["steps"] == [0, 10, 20]
    assert len(hist["test_map"]) == 3
    assert sorted(os.listdir(tmp_path / "models")) == \
        ["qa_iter_0", "qa_iter_10", "qa_iter_20"]
    ev = summary["test_trec_eval"]
    assert ev["map"] == summary["test_map"]
    assert ev["recip_rank"] == summary["test_mrr"]


def test_recipe_twin_asserts_learning(tmp_path):
    """``--min-gain`` stands: two steps do not lift dev MAP by 0.25."""
    with pytest.raises(AssertionError, match="no learning"):
        recipe_scale_rehearsal.main(
            SMALL + ["--cpu", "--max-iter", "2", "--out", str(tmp_path)])


def test_trec_qa_mms_smoke_mode_on_the_cpu(tmp_path):
    out = trec_qa_mms.main(["--out", str(tmp_path)], device="cpu")
    assert {"test_map", "test_mrr"} <= set(out)
    assert 0.0 <= out["test_map"] <= 1.0
    assert np.asarray(out["retrieval_top5"]).shape == (3, 5)
    assert (tmp_path / "models").is_dir()


def test_trec_qa_mms_reads_xml_and_glove_files(tmp_path):
    """The file flags: TREC-QA XML splits and a GloVe text file, written
    here from the synthetic corpus."""
    xml, w2v = JD.synthetic_corpus(n_questions=8, answers_per_q=6, seed=3)
    for name in ("train", "dev", "test"):
        (tmp_path / f"{name}.xml").write_text(xml)
    with open(tmp_path / "glove.txt", "w") as f:
        for word, vec in w2v.items():
            f.write(word + " " + " ".join(f"{v:.6f}" for v in vec) + "\n")
    out = trec_qa_mms.main(
        ["--train-xml", str(tmp_path / "train.xml"),
         "--dev-xml", str(tmp_path / "dev.xml"),
         "--test-xml", str(tmp_path / "test.xml"),
         "--glove", str(tmp_path / "glove.txt"), "--dim", "50",
         "--max-iter", "3", "--out", str(tmp_path / "run")], device="cpu")
    assert 0.0 <= out["test_map"] <= 1.0 and out["best_step"] == 0


def test_twins_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        recipe_scale_rehearsal.main(SMALL + ["--max-iter", "1",
                                             "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        trec_qa_mms.main(["--out", str(tmp_path)])
