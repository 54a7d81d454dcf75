"""The CLI's tools beside the user's path (``extract``, ``saliency``,
``summarize``, ``parse_log``, ``reproduce``, ``device_query``) and
``token_saliency``, and the reference's tools around its databases and
pycaffe (``convert``, ``upgrade``, ``convert_imageset``,
``extract_features``, ``classify``, ``detect``, ``draw``), on CPU
(``--device cpu``), against the JAX package's CLI and functions on one
tiny prepped corpus and one checkpoint.

Tolerances: ``summarize`` and ``parse_log`` outputs byte for byte (the
same formatting code); ``extract``'s probabilities rtol 1e-5 (atol 1e-6)
and embeddings exact (a table lookup plus a bias); saliency within 1e-4
of the array's largest value (a gradient through the whole model, float32
sums in another order); ``reproduce`` (a few steps: the port's weights are
drawn from its own generator, so its numbers are its own) by the files
and lines it writes, and by its verdict and exit code.  The database
tools: ``.caffemodel``, ``.solverstate``, LMDB, LevelDB and prototxt files
byte for byte, checkpoints by their leaves exactly, HDF5 datasets
exactly, ``extract_features``, ``classify`` and ``detect`` outputs within
1e-5 (the same weights, float32 sums in another order), DOT text exactly.
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


# ------------------------------------- the reference's tools (databases)

def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


def _both(capsys, argv_j, argv_t):
    """The JAX CLI, then the port's (``--device cpu`` where it takes
    one); their stdout lines."""
    capsys.readouterr()
    JCLI.main(argv_j)
    j = _lines(capsys)
    cli.main(argv_t)
    return j, _lines(capsys)


def _snapshot(exp):
    from mms_answer_selection_tpu_torch.training.checkpoint import \
        latest_checkpoint

    return latest_checkpoint(str(exp / "models"), prefix="qa")


@pytest.mark.parametrize("out", ["m.caffemodel", "m.caffemodel.h5",
                                 "m.solverstate", "m.solverstate.h5"])
def test_convert_export_writes_jax_s_files(run, capsys, tmp_path, out):
    root, exp = run
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ck = _snapshot(exp)
    j, t = _both(capsys, ["convert", "--ckpt", ck, "--out",
                          str(tmp_path / "j" / out)],
                 ["convert", "--ckpt", ck, "--out", str(tmp_path / "t" / out)])
    assert [ln.replace(str(tmp_path / "t"), str(tmp_path / "j"))
            for ln in t] == j
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("fmt", ["m.caffemodel", "m.caffemodel.h5"])
def test_convert_import_equals_jax_and_round_trips(run, capsys, tmp_path,
                                                   fmt):
    from mms_answer_selection_tpu_torch.training.checkpoint import \
        load_checkpoint

    root, exp = run
    ck = _snapshot(exp)
    cli.main(["convert", "--ckpt", ck, "--out", str(tmp_path / fmt)])
    common = ["convert", "--caffemodel", str(tmp_path / fmt), "--data",
              str(root / "prep"), "--config", str(exp / "cfg.json")]
    j, t = _both(capsys, [*common, "--out", str(tmp_path / "j")],
                 [*common, "--out", str(tmp_path / "t")])
    jr, tr = json.loads(j[-1]), json.loads(t[-1])
    assert tr["report"] == jr["report"] and tr["imported"] == jr["imported"]
    back = {tag: load_checkpoint(str(tmp_path / tag / "imported_iter_0"))
            for tag in ("j", "t")}
    orig, _ = load_checkpoint(ck)
    for tree in ("params", "state"):
        for name, x in _named_np(back["j"][0][tree]).items():
            np.testing.assert_array_equal(_named_np(back["t"][0][tree])[name],
                                          x, err_msg=name)
            np.testing.assert_array_equal(_named_np(orig[tree])[name], x,
                                          err_msg=name)
    assert back["t"][1] == {**back["j"][1]}


def _named_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_convert_prototxt_export_writes_jax_s_files(run, capsys, tmp_path):
    root, exp = run
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    common = ["convert", "--config", str(exp / "cfg.json")]
    _both(capsys, [*common, "--out", str(tmp_path / "j" / "net.prototxt")],
          [*common, "--out", str(tmp_path / "t" / "net.prototxt")])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert len(_files(tmp_path / "t")) == 3


LEGACY_NET = """
name: "legacy"
layers { name: "ip1" type: INNER_PRODUCT bottom: "data" top: "ip1"
  blobs_lr: 1 blobs_lr: 2
  inner_product_param { num_output: 8 weight_filler { type: "xavier" } } }
layers { name: "relu1" type: RELU bottom: "ip1" top: "ip1" }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip1" bottom: "label"
  top: "loss" }
"""
LEGACY_SOLVER = """
net: "net.prototxt"
base_lr: 0.01
lr_policy: "step"
stepsize: 10
gamma: 0.5
momentum: 0.9
max_iter: 100
solver_type: ADAGRAD
"""


@pytest.mark.parametrize("kind", ["net", "solver"])
@pytest.mark.parametrize("to_file", [False, True])
def test_upgrade_text_equals_jax(capsys, tmp_path, kind, to_file):
    src = tmp_path / "in.prototxt"
    src.write_text(LEGACY_NET if kind == "net" else LEGACY_SOLVER)
    outs = {}
    for tag, main in (("j", JCLI.main), ("t", cli.main)):
        argv = ["upgrade", str(src)] + (
            [str(tmp_path / f"{tag}.prototxt")] if to_file else [])
        main(argv)
        outs[tag] = capsys.readouterr().out.replace(f"/{tag}.", "/x.")
        if to_file:
            outs[tag] += (tmp_path / f"{tag}.prototxt").read_text()
    assert outs["t"] == outs["j"]


def _image_list(root, n=12, hw=(6, 5)):
    rng = np.random.default_rng(3)
    (root / "img").mkdir()
    rows = []
    for i in range(n):
        np.save(root / "img" / f"{i}.npy",
                rng.integers(0, 256, hw + (3,)).astype(np.float32))
        rows.append(f"img/{i}.npy {i % 4}")
    (root / "list.txt").write_text("\n".join(rows) + "\n")
    return root / "list.txt"


@pytest.mark.parametrize("backend", ["lmdb", "leveldb", "hdf5"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_convert_imageset_writes_jax_s_database(capsys, tmp_path, backend,
                                                shuffle):
    import h5py

    lst = _image_list(tmp_path)
    extra = ["--backend", backend] + (["--shuffle", "--seed", "5"]
                                      if shuffle else [])
    j, t = _both(capsys, ["convert_imageset", str(tmp_path), str(lst),
                          str(tmp_path / "j"), *extra],
                 ["convert_imageset", str(tmp_path), str(lst),
                  str(tmp_path / "t"), *extra])
    assert [ln.replace(str(tmp_path / "t"), str(tmp_path / "j"))
            for ln in t] == j
    if backend != "hdf5":
        assert _files(tmp_path / "t") == _files(tmp_path / "j")
        return
    assert (tmp_path / "t" / "data.txt").read_text().replace(
        str(tmp_path / "t"), str(tmp_path / "j")) == \
        (tmp_path / "j" / "data.txt").read_text()
    with h5py.File(tmp_path / "t" / "data0.h5") as a, \
            h5py.File(tmp_path / "j" / "data0.h5") as b:
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k][()], b[k][()])


FEAT_NET = """
layer {{ name: "d" type: "Data" top: "data" top: "label"
  data_param {{ source: "{src}" batch_size: 5 backend: LMDB }}
  transform_param {{ scale: 0.00390625 }} }}
layer {{ name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param {{ num_output: 3 kernel_size: 3
    weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "conv" top: "fc"
  inner_product_param {{ num_output: 4 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "prob" type: "Softmax" bottom: "fc" top: "prob" }}
"""


def test_extract_features_equals_jax(capsys, tmp_path):
    from mms_answer_selection_tpu.models.pynet import Net as JNet

    lst = _image_list(tmp_path)
    cli.main(["convert_imageset", str(tmp_path), str(lst),
              str(tmp_path / "db"), "--backend", "lmdb"])
    (tmp_path / "net.prototxt").write_text(
        FEAT_NET.format(src=tmp_path / "db"))
    net = JNet(str(tmp_path / "net.prototxt"), phase="test")
    net.forward()
    net.save(str(tmp_path / "w.caffemodel"))
    common = ["extract_features", "--model", str(tmp_path / "net.prototxt"),
              "--weights", str(tmp_path / "w.caffemodel"), "--blobs",
              "conv,prob,label", "--iterations", "3"]
    j, t = _both(capsys, [*common, "--out", str(tmp_path / "j")],
                 [*common, "--out", str(tmp_path / "t"), "--device", "cpu"])
    assert [ln.replace(str(tmp_path / "t"), str(tmp_path / "j"))
            for ln in t] == j
    for b in ("conv", "prob", "label"):
        want = np.load(tmp_path / "j" / f"{b}.npy")
        got = np.load(tmp_path / "t" / f"{b}.npy")
        assert got.shape == want.shape and got.shape[0] == 15
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(SystemExit, match="Unknown feature blob"):
        cli.main([*common[:5], "--blobs", "nope", "--out",
                  str(tmp_path / "x"), "--device", "cpu"])


DEPLOY = """
name: "tinyclf"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "flat" type: "Flatten" bottom: "data" top: "flat" }
layer { name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


@pytest.fixture
def deploy(tmp_path):
    from mms_answer_selection_tpu.models.classifier import Classifier

    (tmp_path / "deploy.prototxt").write_text(DEPLOY)
    clf = Classifier(str(tmp_path / "deploy.prototxt"))
    clf.predict([np.zeros((8, 8, 3), np.float32)], oversample=False)
    clf.save(str(tmp_path / "w.caffemodel"))
    mean = np.random.default_rng(4).random((1, 3, 8, 8)).astype(np.float32)
    from mms_answer_selection_tpu_torch.utils.caffemodel import \
        save_blob_binaryproto

    save_blob_binaryproto(str(tmp_path / "mean.binaryproto"), mean)
    return tmp_path


@pytest.mark.parametrize("how", ["oversample", "center", "mean_file",
                                 "one_image"])
def test_classify_equals_jax(capsys, deploy, how):
    rng = np.random.default_rng(5)
    src = deploy / "ims.npy"
    np.save(src, rng.random((3, 10, 10, 3)).astype(np.float32)
            if how != "one_image" else rng.random((9, 9, 3)).astype(
                np.float32))
    extra = {"oversample": [], "center": ["--center-only"],
             "mean_file": ["--mean-file", str(deploy / "mean.binaryproto"),
                           "--raw-scale", "1", "--input-scale", "0.5"],
             "one_image": ["--center-only", "--channel-swap", ""]}[how]
    common = [str(src), "--model-def", str(deploy / "deploy.prototxt"),
              "--pretrained-model", str(deploy / "w.caffemodel"),
              "--images-dim", "12,12", *extra]
    j, t = _both(capsys, ["classify", common[0], str(deploy / "j.npy"),
                          *common[1:]],
                 ["classify", common[0], str(deploy / "t.npy"), *common[1:],
                  "--device", "cpu"])
    assert t[0] == j[0] and t[-1].replace("t.npy", "j.npy") == j[-1]
    np.testing.assert_allclose(np.load(deploy / "t.npy"),
                               np.load(deploy / "j.npy"), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("out", ["o.csv", "o.npz"])
@pytest.mark.parametrize("pad", ["0", "2"])
def test_detect_equals_jax(capsys, deploy, out, pad):
    import csv

    im = np.random.default_rng(6).random((20, 20, 3)).astype(np.float32)
    np.save(deploy / "im.npy", im)
    with open(deploy / "win.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "ymin", "xmin", "ymax", "xmax"])
        w.writerow([str(deploy / "im.npy"), 0, 0, 10, 10])
        w.writerow([str(deploy / "im.npy"), 5, 5, 18, 18])
    common = ["--model-def", str(deploy / "deploy.prototxt"),
              "--pretrained-model", str(deploy / "w.caffemodel"),
              "--context-pad", pad, "--mean-file",
              str(deploy / "mean.binaryproto"), "--raw-scale", "1"]
    _both(capsys, ["detect", str(deploy / "win.csv"),
                   str(deploy / f"j{out}"), *common],
          ["detect", str(deploy / "win.csv"), str(deploy / f"t{out}"),
           *common, "--device", "cpu"])
    if out.endswith(".csv"):
        with open(deploy / f"j{out}", newline="") as a, \
                open(deploy / f"t{out}", newline="") as b:
            (jh, *jr), (th, *tr) = list(csv.reader(a)), list(csv.reader(b))
        assert th == jh and len(tr) == len(jr) == 2
        for x, y in zip(tr, jr):
            assert x[:5] == y[:5]
            np.testing.assert_allclose(np.asarray(x[5:], float),
                                       np.asarray(y[5:], float), rtol=1e-5)
    else:
        with np.load(deploy / f"j{out}") as a, \
                np.load(deploy / f"t{out}") as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(b["filenames"], a["filenames"])
            np.testing.assert_array_equal(b["windows"], a["windows"])
            np.testing.assert_allclose(b["predictions"], a["predictions"],
                                       rtol=1e-5)
    with pytest.raises(SystemExit, match="CSV"):
        cli.main(["detect", str(deploy / "win.txt"), str(deploy / "o.csv"),
                  *common, "--device", "cpu"])


@pytest.mark.parametrize("phase", [None, "train", "test"])
def test_draw_equals_jax(capsys, tmp_path, phase):
    from mms_answer_selection_tpu_torch.utils.prototxt import \
        net_prototxt_from_config

    (tmp_path / "net.prototxt").write_text(net_prototxt_from_config(
        TQ.MMSQAConfig(vocab_size=40), phase="eval"))
    argv = ["draw", "--net", str(tmp_path / "net.prototxt"), "--rankdir",
            "TB"] + (["--phase", phase] if phase else [])
    j, t = _both(capsys, argv, argv)
    assert t == j and j[0].startswith("digraph")
    _both(capsys, [*argv, "--out", str(tmp_path / "j.dot")],
          [*argv, "--out", str(tmp_path / "t.dot")])
    assert (tmp_path / "t.dot").read_text() == \
        (tmp_path / "j.dot").read_text()
