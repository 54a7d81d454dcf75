"""GraphSolver and the ``solve`` / ``nettest`` CLI of the port against the
JAX package's, on CPU.

Both solvers read the same solver prototxt and the same ``feeds=`` arrays
with shuffling off (the two packages shuffle with different generators);
the JAX solver's initial params, BN state and solver history are carried
into the port's (their fillers draw differently), then both step.
Tolerances, with their reasons:

* steps: params, BN state and solver history rtol 1e-4, atol 1e-6 (the
  JAX package's own generic-vs-typed pin); smoothed losses rtol 1e-5.  On
  the V4 net a conv bias feeding a train-mode BN has a true gradient of 0
  and a rounding-noise one, which AdaDelta turns into steps of its
  normalized size in either direction: those biases (and their
  accumulators, and the running means of the BN after them) are held to
  the band of both packages' moves, 2 x steps x lr_mult 2 x AdaDelta's
  largest first step;
* test passes and ``nettest`` on the same weights: rtol 1e-5;
* snapshot files written from the same trees: byte for byte;
* a run resumed from a snapshot against the uninterrupted run, both in
  the port on the CPU: bit for bit;
* the ``solve`` CLI over 300 iterations from the same initial weights:
  rtol 1e-4 on the loss and the test outputs (300 float32 steps).
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import cli as jcli
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.training.graph_solver import \
    GraphSolver as JGS
from mms_answer_selection_tpu.utils.caffemodel import save_caffemodel_h5
from mms_answer_selection_tpu.utils.prototxt import net_prototxt_from_config
from mms_answer_selection_tpu_torch.utils.prototxt import parse_prototxt
from mms_answer_selection_tpu_torch import cli as tcli
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.training.graph_solver import \
    GraphSolver as TGS
from mms_answer_selection_tpu_torch.training.signals import Action

h5py = pytest.importorskip("h5py")

ROOT = os.path.join(os.path.dirname(__file__), "..")
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
ADADELTA_STEP = (1e-6 / 0.05) ** 0.5   # lr * sqrt(delta / (1 - momentum))

MLP = """
name: "tiny"
layer { name: "data" type: "Input" top: "data" top: "label" }
layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 16 weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2"
  bottom: "label" top: "loss" }
layer { name: "acc" type: "Accuracy" bottom: "fc2" bottom: "label"
  top: "acc" include { phase: TEST } }
"""


def _solver_text(**kw):
    fields = dict(net='"net.prototxt"', base_lr=0.1, lr_policy='"fixed"',
                  momentum=0.9, weight_decay=0.0005, type='"SGD"',
                  max_iter=5, test_interval=0, random_seed=7,
                  snapshot_prefix='"s"', display=1, average_loss=3)
    fields.update(kw)
    return "".join(f"{k}: {v}\n" for k, v in fields.items())


def _mlp_feeds(n=64, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 3))
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return {"data": {"data": x, "label": y, "batch_size": batch,
                     "shuffle": False}}


def _write(tmp_path, net, **solver):
    (tmp_path / "net.prototxt").write_text(net)
    sp = tmp_path / "solver.prototxt"
    sp.write_text(_solver_text(**solver))
    return str(sp)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


def _carry(jgs, tgs):
    """The JAX solver's params, state, history and test shadows into the
    port's solver."""
    tgs.params, tgs.state = params_from_numpy(_np(jgs.params),
                                              _np(jgs.state), "cpu")
    tgs.opt_state = params_from_numpy(_np(jgs.opt_state), {}, "cpu")[0]
    tgs._test_shadow = [params_from_numpy(*_np(sh), "cpu")
                        for sh in jgs._test_shadow]


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _trees_close(t_tree, j_tree, noise=(), band=0.0):
    t, j = _named(t_tree), _named(_np(j_tree))
    assert t.keys() == j.keys()
    for name, want in j.items():
        if any(name.startswith(n) for n in noise):
            assert np.abs(t[name] - want).max() <= band, name
        else:
            np.testing.assert_allclose(t[name], want, err_msg=name,
                                       **STEP_TOL)


def _pair(tmp_path, net, feeds, **solver):
    sp = _write(tmp_path, net, **solver)
    jgs = JGS(sp, feeds=feeds)
    tgs = TGS(sp, feeds=feeds, device="cpu")
    assert _named(tgs.params).keys() == _named(_np(jgs.params)).keys()
    _carry(jgs, tgs)
    return jgs, tgs


def _train_losses(gs):
    return [r["loss"] for r in gs.history if r["phase"] == "Train"]


# ------------------------------------------------------------- solver steps

@pytest.mark.parametrize("solver_type", ['"SGD"', '"Nesterov"', '"Adam"',
                                         '"AdaGrad"'])
def test_mlp_steps_match(tmp_path, solver_type):
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds(), type=solver_type,
                     base_lr=0.05)
    jgs.step(5)
    tgs.step(5)
    _trees_close(tgs.params, jgs.params)
    _trees_close(tgs.opt_state, jgs.opt_state)
    np.testing.assert_allclose(_train_losses(tgs), _train_losses(jgs),
                               rtol=1e-5)
    np.testing.assert_allclose(tgs.last_outs["loss"].numpy(),
                               np.asarray(jgs.last_outs["loss"]), rtol=1e-5)


def test_iter_size_two_matches(tmp_path):
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds(), iter_size=2,
                     lr_policy='"step"', stepsize=2, gamma=0.5)
    jgs.step(4)
    tgs.step(4)
    _trees_close(tgs.params, jgs.params)
    np.testing.assert_allclose(_train_losses(tgs), _train_losses(jgs),
                               rtol=1e-5)


def test_test_passes_match(tmp_path):
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds(), test_iter=3,
                     test_interval=2)
    jgs.step(4)
    tgs.step(4)
    jt, tt = jgs.test(), tgs.test()
    assert sorted(tt) == sorted(jt) == ["acc", "loss"]
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5, atol=1e-7)
    j_tests = [r for r in jgs.history if r["phase"] == "Test#0"]
    t_tests = [r for r in tgs.history if r["phase"] == "Test#0"]
    assert [r["iter"] for r in t_tests] == [r["iter"] for r in j_tests] \
        == [0, 2, 4]
    for a, b in zip(t_tests, j_tests):
        np.testing.assert_allclose(a["acc"], b["acc"], rtol=1e-5)


V4_CFG = dataclasses.replace(JQ.V4, vocab_size=120, sim_dropout=0.0,
                             fc1_dropout=0.0)


def _qa_feeds(n=6):
    rng = np.random.default_rng(11)
    return {"data": {
        "question": rng.integers(0, 120, (n, 40)).astype(np.int32),
        "answer": rng.integers(0, 120, (n, 40)).astype(np.int32),
        "label": rng.integers(0, 2, (n,)).astype(np.int32),
        "overlap_feat": rng.normal(size=(n, 2)).astype(np.float32),
        "batch_size": n, "shuffle": False}}


def test_v4_net_sgd_then_adadelta_matches(tmp_path):
    """The V4 recipe's net: 5 SGD steps from a xavier W, then, from the
    JAX solver's warm point, 5 AdaDelta steps in each package (the
    recipe's update rule; at W = 0 its first steps would be normalized
    rounding noise, so the warm start comes first)."""
    net = net_prototxt_from_config(V4_CFG)
    jgs, tgs = _pair(tmp_path, net, _qa_feeds())
    w = np.random.default_rng(5).uniform(
        -0.035, 0.035, np.shape(jgs.params["sim_cross"]["w"])).astype(
            np.float32)
    jgs.params = {**_np(jgs.params),
                  "sim_cross": {**_np(jgs.params["sim_cross"]), "w": w}}
    _carry(jgs, tgs)
    jgs.step(5)
    tgs.step(5)
    sgd_noise = ("conv0.b", "conv1.b", "bn0.mean", "bn1.mean")
    _trees_close(tgs.params, jgs.params, sgd_noise, band=1e-3)
    np.testing.assert_allclose(_train_losses(tgs), _train_losses(jgs),
                               rtol=1e-5)

    sp = _write(tmp_path, net, type='"AdaDelta"', base_lr=1.0,
                momentum=0.95, delta=1e-6)
    ja = JGS(sp, feeds=_qa_feeds())
    ta = TGS(sp, feeds=_qa_feeds(), device="cpu")
    ja.params, ja.state = _np(jgs.params), _np(jgs.state)
    ja.opt_state = ja.solver.init(ja.params)
    _carry(ja, ta)
    ja.step(5)
    ta.step(5)
    band = 2 * 5 * 2 * ADADELTA_STEP
    noise = ("conv0.b", "conv1.b")
    _trees_close(ta.params, ja.params, noise, band)
    _trees_close(ta.state, ja.state, ("bn0.mean", "bn1.mean"), band)
    _trees_close(ta.opt_state, ja.opt_state,
                 tuple(f"{a}.{n}" for a in ("h", "h2") for n in noise),
                 band=float("inf"))
    np.testing.assert_allclose(_train_losses(ta), _train_losses(ja),
                               rtol=1e-5)


# --------------------------------------------------- snapshots and restore

def test_snapshot_files_match_jax_byte_for_byte(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for fmt in ("BINARYPROTO", "HDF5"):
        jsp = _write(tmp_path / "j", MLP, snapshot_format=fmt)
        tsp = _write(tmp_path / "t", MLP, snapshot_format=fmt)
        jgs = JGS(jsp, feeds=_mlp_feeds())
        tgs = TGS(tsp, feeds=_mlp_feeds(), device="cpu")
        _carry(jgs, tgs)
        for a, b in zip(jgs.snapshot(), tgs.snapshot()):
            assert os.path.basename(a) == os.path.basename(b)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), (fmt, a)


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_resume_equals_the_uninterrupted_run(tmp_path, fmt):
    sp = _write(tmp_path, MLP, snapshot=3, max_iter=6, snapshot_format=fmt,
                test_iter=1, test_interval=2)
    a = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    a.solve()
    ext = ".solverstate" + (".h5" if fmt == "HDF5" else "")
    b = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    assert b.restore(str(tmp_path / f"s_iter_3{ext}")) == 3
    b.solve()
    for name, x in _named(a.params).items():
        np.testing.assert_array_equal(_named(b.params)[name], x)
    for name, x in _named(a.opt_state).items():
        np.testing.assert_array_equal(_named(b.opt_state)[name], x)
    # the resumed run's test passes read the batches the uninterrupted
    # run's did
    a_tests = {r["iter"]: r["acc"] for r in a.history
               if r["phase"] == "Test#0"}
    b_tests = {r["iter"]: r["acc"] for r in b.history
               if r["phase"] == "Test#0"}
    assert all(a_tests[i] == v for i, v in b_tests.items())


def test_restore_of_a_jax_snapshot_continues_as_jax(tmp_path):
    sp = _write(tmp_path, MLP, snapshot=3, max_iter=6)
    jgs = JGS(sp, feeds=_mlp_feeds())
    jgs.step(3)
    tgs = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    tgs.restore(str(tmp_path / "s_iter_3.solverstate"))
    _trees_close(tgs.params, jgs.params)
    jgs.step(3)
    tgs.step(3)
    _trees_close(tgs.params, jgs.params)
    _trees_close(tgs.opt_state, jgs.opt_state)


def test_copy_weights_from_jax_caffemodel(tmp_path):
    sp = _write(tmp_path, MLP)
    jgs = JGS(sp, feeds=_mlp_feeds())
    jgs.step(2)
    model, _ = jgs.snapshot()
    tgs = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    report = tgs.copy_weights(model)
    assert set(report.values()) == {"loaded"}
    for name, x in _named(_np(jgs.params)).items():
        np.testing.assert_array_equal(_named(tgs.params)[name], x)


def test_signal_actions(tmp_path):
    sp = _write(tmp_path, MLP, max_iter=20, display=0)
    gs = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    fired = []

    def action():
        if gs.iter_ == 3 and not fired:
            fired.append(1)
            return Action.SNAPSHOT
        return Action.STOP if gs.iter_ >= 7 else Action.NONE

    gs.solve(action_fn=action)
    assert gs.iter_ == 7
    assert (tmp_path / "s_iter_3.solverstate").exists()
    assert (tmp_path / "s_iter_7.solverstate").exists()
    calls = []
    gs.callbacks.append((lambda: calls.append("start"),
                         lambda: calls.append("ready")))
    gs.step(2)
    assert calls == ["start", "ready"] * 2


def test_sources_the_port_lacks_raise(tmp_path):
    """Data and WindowData layers are read from the prototxt now
    (``tests/test_torch_db.py``, ``tests/test_torch_io.py``); a layer
    whose source is missing or no database raises naming the layer, as
    the JAX package's does."""
    from mms_answer_selection_tpu.training.graph_solver import \
        _build_feed as j_feed
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        _build_feed as t_feed

    (tmp_path / "empty").mkdir()
    for t, param, msg in (("Data", f'data_param {{ source: "{tmp_path}/empty"'
                           f' batch_size: 2 }}', "neither"),
                          ("Data", "data_param { batch_size: 2 }",
                           "no source"),
                          ("WindowData", "window_data_param { batch_size: 2 }",
                           "no source")):
        net = (f'layer {{ name: "d" type: "{t}" top: "data" top: "label" '
               f'{param} }}\n' + MLP.split("\n", 3)[3])
        sp = _write(tmp_path, net)
        with pytest.raises(ValueError, match=msg):
            TGS(sp, device="cpu")
        cfg = parse_prototxt(net)["layer"][0]
        for feed in (j_feed, t_feed):
            with pytest.raises(ValueError, match="'d'"):
                feed(cfg, "train", 0, str(tmp_path), None)


# ---------------------------------------------------------------------- CLI

def _generic_mlp_dir(tmp_path, sub):
    """examples/generic_mlp's prototxts in ``tmp_path/sub`` with make_data's
    arrays written by h5py beside them (train shuffle off: the packages
    shuffle with different generators)."""
    d = tmp_path / sub
    d.mkdir()
    src = os.path.join(ROOT, "examples", "generic_mlp")
    for f in ("net.prototxt", "solver.prototxt"):
        shutil.copy(os.path.join(src, f), d / f)
    net = (d / "net.prototxt").read_text()
    (d / "net.prototxt").write_text(net.replace("shuffle: true",
                                                "shuffle: false"))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 3))
    for split, n in (("train", 512), ("test", 128)):
        xs = rng.normal(size=(n, 6)).astype(np.float32)
        ys = np.argmax(xs @ w, axis=1).astype(np.float64)
        with h5py.File(d / f"{split}.h5", "w") as f:
            f["data"], f["label"] = xs, ys
        (d / f"{split}.txt").write_text(str(d / f"{split}.h5") + "\n")
    return d


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close_json(got, want, rtol):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _close_json(got[k], v, rtol)
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def test_solve_and_nettest_cli_match_jax(tmp_path, capsys):
    jd = _generic_mlp_dir(tmp_path, "j")
    td = _generic_mlp_dir(tmp_path, "t")
    # one set of initial weights for both: the JAX solver's init
    init = str(tmp_path / "init.caffemodel.h5")
    g0 = JGS(str(jd / "solver.prototxt"))
    save_caffemodel_h5(init, g0.params, g0.state,
                       specs=g0.net.caffemodel_specs(g0.params, g0.state))
    jcli.main(["solve", "--solver", str(jd / "solver.prototxt"),
               "--weights", init])
    j_out = _last_json(capsys)
    tcli.main(["solve", "--solver", str(td / "solver.prototxt"),
               "--weights", init, "--device", "cpu"])
    t_out = _last_json(capsys)
    assert t_out["iter"] == j_out["iter"] == 300
    assert t_out["last_test"]["acc"] > 0.9
    _close_json(t_out, j_out, 1e-4)
    for ext in (".caffemodel.h5", ".solverstate.h5"):
        assert (td / f"snap_iter_300{ext}").exists()

    jw = str(jd / "snap_iter_300.caffemodel.h5")
    tw = str(td / "snap_iter_300.caffemodel.h5")
    jcli.main(["nettest", "--model", str(jd / "net.prototxt"), "--weights",
               jw, "--iterations", "2"])
    j_test = _last_json(capsys)
    tcli.main(["nettest", "--model", str(td / "net.prototxt"), "--weights",
               jw, "--iterations", "2", "--device", "cpu"])
    _close_json(_last_json(capsys), j_test, 1e-5)
    tcli.main(["nettest", "--model", str(td / "net.prototxt"), "--weights",
               tw, "--iterations", "2", "--device", "cpu"])
    _close_json(_last_json(capsys), j_test, 1e-4)

    # resume the port's run from its own solverstate: it ends where it was
    tcli.main(["solve", "--solver", str(td / "solver.prototxt"),
               "--snapshot", str(td / "snap_iter_300.solverstate.h5"),
               "--device", "cpu"])
    assert _last_json(capsys)["iter"] == 300


def test_solve_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    d = _generic_mlp_dir(tmp_path, "c")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["solve", "--solver", str(d / "solver.prototxt")])
