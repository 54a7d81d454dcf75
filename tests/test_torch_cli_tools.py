"""The CLI's tools beside the user's path (``extract``, ``saliency``,
``summarize``, ``parse_log``, ``reproduce``, ``device_query``) and
``token_saliency``, on CPU (``--device cpu``), against the JAX package's
CLI and functions on one tiny prepped corpus and one checkpoint.

Tolerances: ``summarize`` and ``parse_log`` outputs byte for byte (the
same formatting code); ``extract``'s probabilities rtol 1e-5 (atol 1e-6)
and embeddings exact (a table lookup plus a bias); saliency within 1e-4
of the array's largest value (a gradient through the whole model, float32
sums in another order); ``reproduce`` (a few steps: the port's weights are
drawn from its own generator, so its numbers are its own) by the files
and lines it writes, and by its verdict and exit code.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import cli as JCLI
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.utils.saliency import (
    token_saliency as j_token_saliency,
)
from mms_answer_selection_tpu_torch import cli
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.data import synthetic_corpus
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.training import SolverConfig, TrainerConfig
from mms_answer_selection_tpu_torch.utils import config as TConfig
from mms_answer_selection_tpu_torch.utils.saliency import (
    save_saliency_png,
    token_saliency,
)

SAL_RTOL = 1e-4


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.strip().split("\n") if ln]


def _sal_close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= SAL_RTOL * scale


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A corpus as XML + GloVe text, prepped by the port's CLI, and a few
    steps trained from it (the best checkpoint and history.json)."""
    root = tmp_path_factory.mktemp("tools")
    xml, w2v = synthetic_corpus(n_questions=8, answers_per_q=5, seed=9)
    (root / "d.xml").write_text(xml)
    with open(root / "glove.txt", "w") as f:
        for w, v in w2v.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    cli.main(["prep", "--train-xml", str(root / "d.xml"), "--dev-xml",
              str(root / "d.xml"), "--test-xml", str(root / "d.xml"),
              "--glove", str(root / "glove.txt"), "--out",
              str(root / "prep"), "--q-len", "12", "--a-len", "12"])
    meta = json.loads((root / "prep" / "meta.json").read_text())
    model = TQ.MMSQAConfig(
        vocab_size=meta["vocab_size"], embed_dim=50, question_len=12,
        answer_len=12, sim_measures=2, sim_weight_init="xavier",
        blocks=(TQ.ConvBlock(3, 3, 4, "ave", 2, 2),
                TQ.ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
    exp = root / "exp"
    exp.mkdir()
    trainer = TrainerConfig(solver=SolverConfig(), max_iter=8, batch_size=10,
                            test_interval=4, snapshot_interval=4,
                            early_stop_patience=99,
                            snapshot_dir=str(exp / "models"))
    (exp / "cfg.json").write_text(TConfig.experiment_to_json(model, trainer))
    cli.main(["train", "--data", str(root / "prep"), "--exp", str(exp),
              "--config", str(exp / "cfg.json"), "--device", "cpu"])
    return root, exp


def test_extract_equals_jax(run, capsys):
    root, exp = run
    common = ["extract", "--data", str(root / "prep"), "--exp", str(exp),
              "--split", "dev"]
    cli.main([*common, "--out", str(root / "t.npz"), "--device", "cpu"])
    JCLI.main([*common, "--out", str(root / "j.npz")])
    assert _lines(capsys)[-2:] == [f"wrote {root / 't.npz'}",
                                   f"wrote {root / 'j.npz'}"]
    with np.load(root / "t.npz") as t, np.load(root / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) == sorted(
            ["prob", "question_embeddings", "answer_embeddings", "label",
             "group"])
        np.testing.assert_allclose(t["prob"], j["prob"], rtol=1e-5,
                                   atol=1e-6)
        for k in ("question_embeddings", "answer_embeddings", "label",
                  "group"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the default output path is the JAX CLI's
    cli.main(["extract", "--data", str(root / "prep"), "--exp", str(exp),
              "--device", "cpu"])
    assert (exp / "features_test.npz").exists()


def test_saliency_cli_equals_jax(run, capsys):
    root, exp = run
    common = ["saliency", "--data", str(root / "prep"), "--exp", str(exp),
              "-n", "5"]
    cli.main([*common, "--out", str(root / "t_sal.png"), "--device", "cpu"])
    JCLI.main([*common, "--out", str(root / "j_sal.png")])
    lines = _lines(capsys)
    assert f"wrote {root / 't_sal.npz'}" in lines
    assert (root / "t_sal.png").exists() == (root / "j_sal.png").exists()
    with np.load(root / "t_sal.npz") as t, np.load(root / "j_sal.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == (5, 12)
            _sal_close(t[k], j[k])


def test_token_saliency_equals_jax():
    jcfg = dataclasses.replace(
        JQ.V4, vocab_size=40, embed_dim=10, question_len=9, answer_len=7,
        sim_weight_init="xavier", fc1_dim=6,
        blocks=(JQ.ConvBlock(3, 3, 4, "ave", 2, 2),))
    tcfg = TQ.MMSQAConfig(**{**jcfg.__dict__, "blocks": (
        TQ.ConvBlock(3, 3, 4, "ave", 2, 2),)})
    jp, js = jax.device_get(JQ.mms_qa_init(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    js = {k: {"mean": 0.1 * rng.normal(size=v["mean"].shape).astype(
        np.float32), "var": rng.random(v["var"].shape).astype(np.float32)
        + 0.5} for k, v in js.items()}
    batch = {"question": rng.integers(0, 40, (6, 9)).astype(np.int32),
             "answer": rng.integers(0, 40, (6, 7)).astype(np.int32),
             "overlap_feat": rng.random((6, 2)).astype(np.float32),
             "label": (rng.random(6) < 0.5).astype(np.int32)}
    jq, ja = j_token_saliency(jp, js, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, jcfg)
    tp, ts = params_from_numpy(jp, js, "cpu")
    tq, ta = token_saliency(tp, ts, {k: torch.as_tensor(v) for k, v in
                                     batch.items()}, tcfg)
    _sal_close(tq, np.asarray(jq))
    _sal_close(ta, np.asarray(ja))
    assert tq.shape == (6, 9) and ta.shape == (6, 7) and tq.min() >= 0
    # the params themselves are left without gradients
    assert all(t.grad is None for t in (tp["embed"]["w"], tp["sim"]["w"]))


def test_save_saliency_png(tmp_path, monkeypatch):
    q, a = np.ones((2, 3)), np.zeros((2, 4))
    assert save_saliency_png(str(tmp_path / "s.png"), q, a)
    assert (tmp_path / "s.png").stat().st_size > 0
    import builtins

    real = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert save_saliency_png(str(tmp_path / "n.png"), q, a) is False
    assert not (tmp_path / "n.png").exists()


@pytest.mark.parametrize("how", ["variant", "config"])
def test_summarize_equals_jax(run, capsys, how, tmp_path):
    _, exp = run
    hist = tmp_path / "history.json"
    hist.write_text((exp / "history.json").read_text())
    flags = (["--variant", "v5"] if how == "variant"
             else ["--config", str(exp / "cfg.json")])
    cli.main(["summarize", *flags, "--history", str(hist)])
    got = capsys.readouterr().out
    csvs = [(tmp_path / f"history.{n}.csv").read_text()
            for n in ("train", "eval")]
    JCLI.main(["summarize", *flags, "--history", str(hist)])
    assert got == capsys.readouterr().out
    assert csvs == [(tmp_path / f"history.{n}.csv").read_text()
                    for n in ("train", "eval")]
    assert "TOTAL" in got and csvs[1].startswith("NumIters,dev_map")


GLOG = """\
I0817 14:03:12.000000  1 solver.cpp:1] Solving net
I0817 14:03:12.100000  1 solver.cpp:2] Iteration 0, Testing net (#0)
I0817 14:03:12.200000  1 solver.cpp:3]     Test net output #0: accuracy = 0.5
I0817 14:03:12.200000  1 solver.cpp:3]     Test net output #1: loss = 0.69
I0817 14:03:13.000000  1 solver.cpp:4] Iteration 0, loss = 0.7
I0817 14:03:13.000000  1 solver.cpp:5]     Train net output #0: loss = 0.7
I0817 14:03:13.000000  1 sgd_solver.cpp:6] Iteration 0, lr = 0.01
I0817 14:03:15.500000  1 solver.cpp:4] Iteration 50, loss = 0.4
I0817 14:03:15.500000  1 solver.cpp:5]     Train net output #0: loss = 0.41
I0817 14:03:15.500000  1 sgd_solver.cpp:6] Iteration 50, lr = 0.005
I0817 14:03:16.000000  1 solver.cpp:2] Iteration 100, Testing net (#0)
I0817 14:03:16.100000  1 solver.cpp:3]     Test net output #0: accuracy = 0.8
I0817 14:03:16.100000  1 solver.cpp:3]     Test net output #1: loss = 0.3
"""


def test_parse_log_equals_jax(tmp_path, capsys):
    log = tmp_path / "train.log"
    log.write_text(GLOG)
    cli.main(["parse_log", str(log), "--out-dir", str(tmp_path / "t")])
    got = _lines(capsys)
    JCLI.main(["parse_log", str(log), "--out-dir", str(tmp_path / "j")])
    assert [ln.replace("/j/", "/t/") for ln in _lines(capsys)] == got
    for ext in ("train", "test"):
        t = (tmp_path / "t" / f"train.log.{ext}").read_text()
        assert t == (tmp_path / "j" / f"train.log.{ext}").read_text()
        assert t.startswith("NumIters,Seconds,LearningRate")
    cli.main(["parse_log", str(log)])              # beside the log
    assert (tmp_path / "train.log.test").read_text().count("\n") == 3


def test_reproduce_runs_the_recipe_as_jax_does(run, capsys):
    root, _ = run
    common = ["reproduce", "--train-xml", str(root / "d.xml"), "--dev-xml",
              str(root / "d.xml"), "--test-xml", str(root / "d.xml"),
              "--glove", str(root / "glove.txt"), "--max-iter", "3"]
    outs = {}
    for name, main, extra in (("t", cli.main, ["--device", "cpu"]),
                              ("j", JCLI.main, [])):
        main([*common, "--out", str(root / f"rep_{name}"), "--tolerance",
              "1.0", *extra])
        outs[name] = _lines(capsys)
    for lines in outs.values():
        assert lines[-1].startswith("reproduce PASS: MAP ")
    # the same table rows and trec_eval.json keys, truth file byte for byte
    assert [ln.split()[0] for ln in outs["t"]] == \
        [ln.split()[0] for ln in outs["j"]]
    t = json.loads((root / "rep_t" / "trec_eval.json").read_text())
    j = json.loads((root / "rep_j" / "trec_eval.json").read_text())
    assert t.keys() == j.keys() and 0.0 <= t["map"] <= 1.0
    assert (root / "rep_t" / "truth").read_bytes() == \
        (root / "rep_j" / "truth").read_bytes()
    with pytest.raises(SystemExit) as e:
        cli.main([*common, "--out", str(root / "rep_t"), "--tolerance", "0",
                  "--expected-map", "2", "--device", "cpu"])
    assert e.value.code == 1
    assert _lines(capsys)[-1].startswith("reproduce FAIL: MAP ")


def test_device_query_keys_are_jax_s(capsys):
    cli.main(["device_query", "--device", "cpu"])
    got = [json.loads(ln) for ln in _lines(capsys)]
    JCLI.main(["device_query"])
    want = [json.loads(ln) for ln in _lines(capsys)]
    assert got[0].keys() >= want[0].keys()
    assert got[0]["platform"] == want[0]["platform"] == "cpu"
    if not torch.cuda.is_available():              # no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["device_query"])
