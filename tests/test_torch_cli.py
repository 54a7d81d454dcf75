"""The port's command-line tool, ``prep`` -> ``train`` -> ``eval`` ->
``serve``, on CPU (``--device cpu``), against the JAX package's CLI on the
same corpus: prep's artifacts byte for byte, ``config.json`` text equal,
a streamed run interrupted and resumed equal to the uninterrupted one, and
``eval`` / ``serve`` of the port's checkpoint answering as the JAX CLI
does on the same checkpoint.

Tolerances: prep, config text and the resumed run exact; ``eval``'s
metrics and ``serve``'s scores against the JAX CLI's at rtol 1e-5 (atol
1e-6): the same weights and bf16 pool, float32 sums in another order; the
port's ``trec_eval`` MAP against its in-graph MAP to 1e-6.
"""

import json
import os
import threading
import time
import urllib.request
from argparse import Namespace

import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import cli as JCLI
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    TrainerConfig as JTrainerConfig,
)
from mms_answer_selection_tpu.utils import config as JConfig
from mms_answer_selection_tpu_torch import cli
from mms_answer_selection_tpu_torch.data import synthetic_corpus
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    TrainerConfig,
)
from mms_answer_selection_tpu_torch.training.checkpoint import load_checkpoint
from mms_answer_selection_tpu_torch.utils import config as TConfig


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.strip().split("\n") if ln]


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    """One corpus prepped by both CLIs (with the packed store)."""
    root = tmp_path_factory.mktemp("cli")
    xml, w2v = synthetic_corpus(n_questions=8, answers_per_q=5, seed=4)
    (root / "d.xml").write_text(xml)
    with open(root / "glove.txt", "w") as f:
        for w, v in w2v.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    for main, out in ((cli.main, "prep"), (JCLI.main, "jprep")):
        main(["prep", "--train-xml", str(root / "d.xml"), "--dev-xml",
              str(root / "d.xml"), "--test-xml", str(root / "d.xml"),
              "--glove", str(root / "glove.txt"), "--out", str(root / out),
              "--q-len", "12", "--a-len", "12", "--mmsp"])
    meta = json.loads((root / "prep" / "meta.json").read_text())
    model = TQ.MMSQAConfig(
        vocab_size=meta["vocab_size"], embed_dim=50, question_len=12,
        answer_len=12, sim_measures=2,
        blocks=(TQ.ConvBlock(3, 3, 4, "ave", 2, 2),
                TQ.ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
    return root, model


def _config(root, model, name, **kw):
    exp = root / name
    exp.mkdir()
    trainer = TrainerConfig(**(dict(
        solver=SolverConfig(), max_iter=30, batch_size=10, test_interval=5,
        snapshot_interval=5, early_stop_patience=99,
        snapshot_dir=str(exp / "models")) | kw))
    (exp / "cfg.json").write_text(TConfig.experiment_to_json(model, trainer))
    return exp


def _train(root, exp, *extra):
    cli.main(["train", "--data", str(root / "prep"), "--exp", str(exp),
              "--config", str(exp / "cfg.json"), "--device", "cpu", *extra])


def test_prep_artifacts_equal_jax(prepped):
    root, _ = prepped
    t, j = root / "prep", root / "jprep"
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    for name in ("meta.json", "train.mmsp"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    for name in ("train.npz", "dev.npz", "test.npz", "vocab.npz"):
        with np.load(t / name) as a, np.load(j / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_config_json_equals_jax(prepped):
    root, model = prepped
    jmodel = JQ.MMSQAConfig(**{**model.__dict__, "blocks": tuple(
        JQ.ConvBlock(**b.__dict__) for b in model.blocks)})
    jtrainer = JTrainerConfig(
        solver=JSolverConfig(solver_type="adam", stepvalues=(5, 10)),
        max_iter=77, snapshot_dir="x")
    trainer = TrainerConfig(
        solver=SolverConfig(solver_type="adam", stepvalues=(5, 10)),
        max_iter=77, snapshot_dir="x")
    text = TConfig.experiment_to_json(model, trainer)
    assert text == JConfig.experiment_to_json(jmodel, jtrainer)
    assert TConfig.experiment_from_json(text) == (model, trainer)
    raw = json.loads(text)
    del raw["config_version"]                       # a v0 file
    assert TConfig.experiment_from_json(json.dumps(raw)) == (model, trainer)
    raw["config_version"] = 2
    with pytest.raises(ValueError, match="newer"):
        TConfig.experiment_from_json(json.dumps(raw))
    # the config the CLI writes: with --config, and the default one a
    # data dir's meta gives
    meta = json.loads((root / "prep" / "meta.json").read_text())
    exp = _config(root, model, "cfg_exp", max_iter=1)
    _train(root, exp)
    assert (exp / "config.json").read_text() == JConfig.experiment_to_json(
        *JCLI._experiment_configs(Namespace(config=str(exp / "cfg.json")),
                                  meta))
    # unlike the JAX CLI, which ignores it beside --config, --max-iter
    # overrides the file's max_iter (and config.json records it)
    _train(root, exp, "--max-iter", "2")
    assert json.loads((exp / "config.json").read_text())["trainer"][
        "max_iter"] == 2
    args = Namespace(config=None, exp=str(root / "d_exp"), max_iter=3)
    assert TConfig.experiment_to_json(*cli._experiment_configs(args, meta)) \
        == JConfig.experiment_to_json(*JCLI._experiment_configs(args, meta))


@pytest.fixture(scope="module")
def trained(prepped):
    """A streamed run to step 30, and the same run interrupted at 15 and
    resumed (``--resume``, 4 steps a chunk)."""
    root, model = prepped
    full = _config(root, model, "full")
    _train(root, full, "--stream")
    part = _config(root, model, "part")
    _train(root, part, "--stream", "--max-iter", "16")
    _train(root, part, "--stream", "--resume", "--fused-steps", "4")
    return root, full, part


def test_train_stream_resume_equals_the_uninterrupted_run(trained):
    _, full, part = trained
    for name in ("history.json", "truth", "result"):
        assert (full / name).read_bytes() == (part / name).read_bytes(), name
    hist = json.loads((full / "history.json").read_text())
    assert hist["steps"] == [0, 5, 10, 15, 20, 25]
    assert "params" not in hist
    best = f"best_iter_{hist['best_step']}"
    for d in ("models/qa_iter_25", best):
        a, ma = load_checkpoint(str(full / d))
        b, mb = load_checkpoint(str(part / d))
        assert ma == mb
        for x, y in zip(_leaves(a), _leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert json.loads((full / "models/qa_iter_25/meta.json").read_text())[
        "stream"] is True


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_eval_equals_jax_on_the_same_checkpoint(trained, capsys):
    root, full, _ = trained
    capsys.readouterr()
    common = ["--data", str(root / "prep"), "--exp", str(full)]
    cli.main(["eval", *common, "--device", "cpu"])
    got = json.loads(_lines(capsys)[-1])
    JCLI.main(["eval", *common])
    want = json.loads(_lines(capsys)[-1])
    assert abs(got["trec_map"] - got["in_graph_map"]) < 1e-6
    assert abs(got["trec_mrr"] - got["in_graph_mrr"]) < 1e-6
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("flags", [[], ["--rerank", "8"]],
                         ids=["query", "rerank"])
def test_serve_one_shot_equals_jax(trained, capsys, flags):
    root, full, _ = trained
    capsys.readouterr()
    common = ["--data", str(root / "prep"), "--exp", str(full), "--k", "4",
              "--n-queries", "3", *flags]
    cli.main(["serve", *common, "--device", "cpu"])
    got = [json.loads(ln) for ln in _lines(capsys)]
    JCLI.main(["serve", *common])
    want = [json.loads(ln) for ln in _lines(capsys)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["query"] == w["query"]
        np.testing.assert_array_equal([i for i, _ in g["topk"]],
                                      [i for i, _ in w["topk"]])
        np.testing.assert_allclose([v for _, v in g["topk"]],
                                   [v for _, v in w["topk"]], rtol=1e-5,
                                   atol=1e-6)


def test_serve_listen_with_a_saved_index(trained, capsys):
    """--int8 --index: the first run builds and saves, the next loads it
    (warm restart) and answers over HTTP like the engine; the module hook
    stops the server."""
    root, full, _ = trained
    index = str(root / "pool.npz")
    common = ["serve", "--data", str(root / "prep"), "--exp", str(full),
              "--int8", "--k", "3", "--index", index, "--device", "cpu"]
    capsys.readouterr()
    cli.main([*common, "--n-queries", "2"])
    lines = _lines(capsys)
    assert json.loads(lines[0]) == {"index_saved": index}
    cold = [json.loads(ln) for ln in lines[1:]]
    cli._LAST_SERVER = None
    th = threading.Thread(target=cli.main,
                          args=([*common, "--listen", "0"],), daemon=True)
    th.start()
    for _ in range(600):
        if cli._LAST_SERVER is not None:
            break
        time.sleep(0.05)
    srv = cli._LAST_SERVER
    base = f"http://{srv.host}:{srv.port}"
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["pool_dtype"] == "int8" and health["text_queries"]
    from mms_answer_selection_tpu_torch.data import load_dataset
    q = load_dataset(str(root / "prep" / "test.npz"))["question"][:2]
    req = urllib.request.Request(
        base + "/query", data=json.dumps({"tokens": q.tolist()}).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        got = json.loads(r.read())["results"]
    assert [r["topk"] for r in got] == [c["topk"] for c in cold]
    srv.httpd.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()
    warm = json.loads(_lines(capsys)[0])
    assert warm["index_loaded"] == index and warm["pool"] == 40


def test_weights_finetune_and_default_device(trained):
    root, full, _ = trained
    tuned = root / "tuned"
    tuned.mkdir()
    (tuned / "cfg.json").write_text((full / "cfg.json").read_text())
    hist = json.loads((full / "history.json").read_text())
    _train(root, tuned, "--weights",
           str(full / f"best_iter_{hist['best_step']}"), "--max-iter", "6")
    assert json.loads((tuned / "history.json").read_text())["steps"] == [0,
                                                                          5]
    with pytest.raises(ValueError, match="mutually exclusive"):
        _train(root, tuned, "--weights", str(full), "--resume")
    if not torch.cuda.is_available():      # no fallback to the CPU
        for cmd in (["train", "--config", str(tuned / "cfg.json")],
                    ["eval"], ["serve"]):
            with pytest.raises(RuntimeError, match="cuda"):
                cli.main([cmd[0], "--data", str(root / "prep"), "--exp",
                          str(full), *cmd[1:]])


def test_serve_pool_dtype_ivf_and_batch_window_flags(trained, capsys):
    """--pool-dtype int4 one-shot; --ivf-clusters with --coarse-tokens and
    --batch-window-ms behind --listen answer a coarse-shortlist query."""
    root, full, _ = trained
    common = ["serve", "--data", str(root / "prep"), "--exp", str(full),
              "--k", "3", "--device", "cpu"]
    capsys.readouterr()
    cli.main([*common, "--pool-dtype", "int4", "--n-queries", "2"])
    assert [len(json.loads(ln)["topk"]) for ln in _lines(capsys)] == [3, 3]
    cli._LAST_SERVER = None
    th = threading.Thread(target=cli.main, args=([
        *common, "--ivf-clusters", "4", "--coarse-tokens", "2",
        "--batch-window-ms", "5", "--listen", "0"],), daemon=True)
    th.start()
    for _ in range(600):
        if cli._LAST_SERVER is not None:
            break
        time.sleep(0.05)
    srv = cli._LAST_SERVER
    try:
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/query",
            data=json.dumps({"text": "w1 w2", "shortlist": 8}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.loads(r.read())
        assert len(got["results"][0]["topk"]) == 3
        assert srv.health()["ivf"] and srv.batch_window_ms == 5.0
    finally:
        srv.httpd.shutdown()
        th.join(timeout=30)
    assert not th.is_alive()
