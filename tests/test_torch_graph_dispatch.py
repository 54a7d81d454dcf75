"""The generic prototxt path as one dispatch per JAX program, on CPU:
``GraphSolver``'s step through its ``StepRunner``, its test passes and the
pycaffe forwards through ``GraphedCall`` (``training/dispatch.py``,
``utils/graphs.py``).  On the CPU the runner and ``GraphedCall`` run the
same bodies eagerly on their static buffers, so these tests hold the
buffers, keys, seeds and the static carry to the eager code and to the
JAX package.

Tolerances, with their reasons:

* the runner's steps, test passes and forwards against the port's own
  eager code (``_train_step``, ``_test_outputs_eager``): bit for bit (the
  same float32 operations in the same order on the same inputs; the
  iteration a 0-d tensor computes the learning rate's float32 value the
  int gives);
* against the JAX package after ``restore`` / ``copy_weights`` and for the
  pycaffe forwards: ``tests/test_torch_graph_solver.py``'s and
  ``tests/test_torch_pycaffe.py``'s tolerances (rtol 1e-4 on params and
  solver history after steps, 1e-5 of a blob's largest value for
  forwards), since the two packages sum float32 in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import netspec_v4
from mms_answer_selection_tpu import caffe_compat as jcaffe
from mms_answer_selection_tpu.training.graph_solver import \
    GraphSolver as JGS
from mms_answer_selection_tpu_torch import caffe_compat as tcaffe
from mms_answer_selection_tpu_torch.device import set_pycaffe_mode
from mms_answer_selection_tpu_torch.training.dispatch import (
    ChunkRunner, StepRunner)
from mms_answer_selection_tpu_torch.training.graph_solver import \
    GraphSolver as TGS
from mms_answer_selection_tpu_torch.utils.graphs import GraphedCall
from tests.test_torch_graph_solver import (MLP, _carry, _mlp_feeds, _named,
                                           _np, _pair, _qa_feeds,
                                           _trees_close, _write)
from tests.test_torch_pycaffe import (BLOB_RTOL, V4_STILL, _close_rel,
                                      _mlp_pair, _v4_pair)

# a train net with both kinds of random layer: a gaussian DummyData added
# to fc1, and Dropout; its TEST phase keeps the DummyData (it refills on
# every pass) and drops nothing
NOISY = """
name: "noisy"
layer { name: "data" type: "Input" top: "data" top: "label" }
layer { name: "noise" type: "DummyData" top: "noise"
  dummy_data_param { shape { dim: 16 dim: 16 }
    data_filler { type: "gaussian" std: 0.3 } } }
layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 16 weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "mix" type: "Eltwise" bottom: "fc1" bottom: "noise"
  top: "mix" eltwise_param { operation: SUM } }
layer { name: "relu1" type: "ReLU" bottom: "mix" top: "mix" }
layer { name: "drop" type: "Dropout" bottom: "mix" top: "mix"
  dropout_param { dropout_ratio: 0.3 } }
layer { name: "fc2" type: "InnerProduct" bottom: "mix" top: "fc2"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2"
  bottom: "label" top: "loss" }
layer { name: "acc" type: "Accuracy" bottom: "fc2" bottom: "label"
  top: "acc" include { phase: TEST } }
"""

# (solver type, the solver fields that go with it): all six types
# GraphSolver builds, and every lr policy that reads the iteration
SOLVERS = [
    ('"SGD"', dict(lr_policy='"step"', stepsize=2, gamma=0.5)),
    ('"Nesterov"', dict(lr_policy='"inv"', gamma=0.1, power=0.75)),
    ('"AdaGrad"', dict(lr_policy='"multistep"', stepvalue=2, gamma=0.5)),
    ('"RMSProp"', dict(lr_policy='"exp"', gamma=0.9, rms_decay=0.98)),
    ('"AdaDelta"', dict(base_lr=1.0, momentum=0.95, delta=1e-6)),
    ('"Adam"', dict(lr_policy='"poly"', power=1.0, max_iter=10,
                    momentum=0.9, momentum2=0.999, delta=1e-8)),
]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: six tier-1 workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal_trees(got, want):
    g, w = _named(got), _named(want)
    assert g.keys() == w.keys()
    for name, x in w.items():
        np.testing.assert_array_equal(g[name], x, err_msg=name)


def _eager_steps(gs, n):
    """``n`` iterations of the plain ``_train_step``: their mean losses
    and the last micro-batch's output blobs."""
    losses, outs = [], None
    for _ in range(n):
        loss, outs = gs._train_step()
        losses.append(float(loss))
        gs.iter_ += 1
    return losses, outs


def _runner_steps(gs, n):
    """``n`` iterations of ``step``: their mean losses, as the smoothed
    loss's window holds them (``average_loss`` >= n)."""
    assert gs.average_loss >= n
    gs.step(n)
    return list(gs._losses)


# ------------------------------------------------------- the solver step

@pytest.mark.parametrize("iter_size", [1, 2])
def test_step_through_the_runner_is_the_eager_loop_bit_for_bit(tmp_path,
                                                               iter_size):
    sp = _write(tmp_path, NOISY, iter_size=iter_size, max_iter=8,
                average_loss=8)
    a = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    b = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    got = _runner_steps(a, 4)
    want, outs = _eager_steps(b, 4)
    assert got == want
    for name in ("params", "state", "opt_state"):
        _equal_trees(getattr(a, name), getattr(b, name))
    assert a.last_outs.keys() == outs.keys() == {"loss"}
    assert torch.equal(a.last_outs["loss"], outs["loss"])
    runner = a.runner
    assert isinstance(runner, StepRunner) and not runner.captures
    assert runner.replays == 0                         # the CPU: eager
    assert [(c["k"], c["replays"]) for c in runner.stats()] == [(1, 0)]
    # the noise and the dropout draw: a step does not repeat the last
    assert len(set(got)) == 4


@pytest.mark.parametrize("solver_type,fields", SOLVERS,
                         ids=[s[0].strip('"') for s in SOLVERS])
def test_every_solver_type_steps_through_the_runner_bit_for_bit(
        tmp_path, solver_type, fields):
    sp = _write(tmp_path, NOISY, type=solver_type, iter_size=2,
                average_loss=5, **{"base_lr": 0.05, **fields})
    a = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    b = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    assert a.cfg.solver_type == solver_type.strip('"').lower()
    got = _runner_steps(a, 5)
    want, _ = _eager_steps(b, 5)
    assert got == want
    _equal_trees(a.params, b.params)
    _equal_trees(a.opt_state, b.opt_state)


def test_a_net_with_no_feed_steps_through_the_runner(tmp_path):
    """A train net fed by DummyData alone: the runner's step takes no
    input buffer and still draws the eager step's data."""
    net = """
    layer { name: "d" type: "DummyData" top: "data" top: "label"
      dummy_data_param { shape { dim: 16 dim: 6 } shape { dim: 16 }
        data_filler { type: "gaussian" std: 1.0 }
        data_filler { type: "constant" value: 1 } } }
    layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
      inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
    layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc"
      bottom: "label" top: "loss" }
    """
    sp = _write(tmp_path, net, average_loss=3)
    a, b = TGS(sp, device="cpu"), TGS(sp, device="cpu")
    assert _runner_steps(a, 3) == _eager_steps(b, 3)[0]
    _equal_trees(a.params, b.params)
    (stats,) = a.runner.stats()
    assert stats["k"] == 1


def test_runner_seeds_keep_each_owner_s_rule(tmp_path):
    """GraphSolver seeds micro-batch 0 as (iter, 0) even at iter_size 1;
    the Trainer's runner drops the index there, as its eager step does."""
    from tests.test_torch_dispatch import _trainer

    for iter_size in (1, 2):
        tr, _ = _trainer(iter_size)
        runner = ChunkRunner(tr, tr.init())
        for j in range(iter_size):
            want = tr._dropout_seed(7) if iter_size == 1 \
                else tr._dropout_seed(7, j)
            assert runner.seed(7, j) == want
    gs = TGS(_write(tmp_path, MLP), feeds=_mlp_feeds(), device="cpu")
    gs.step(1)
    assert gs.runner.seed(3, 0) == gs._step_seed(3, 0) != gs._step_seed(3, 1)


def test_rebound_weights_are_copied_into_the_static_carry(tmp_path):
    """A tree or an entry rebound between steps reaches the next step (the
    runner's carry is copied into, not replaced); the runner and its
    graphs are kept."""
    sp = _write(tmp_path, NOISY)
    a = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    b = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    a.step(2)
    _eager_steps(b, 2)
    runner = a.runner
    held = a.params["fc1"]["w"]
    w = torch.linspace(-1, 1, held.numel()).reshape(held.shape)
    for gs in (a, b):
        gs.params["fc1"]["w"] = w.clone()              # an entry rebound
        gs.state = dict(gs.state)                      # a tree rebound
    a.step(2)
    _eager_steps(b, 2)
    _equal_trees(a.params, b.params)
    assert a.runner is runner
    assert a.params["fc1"]["w"] is held                # the static leaf
    assert a.runner.view()[0]["fc1"]["w"] is held


# ------------------------------------------------------------ test passes

def test_test_pass_replay_equals_its_eager_pass(tmp_path):
    """A test net with a random DummyData: each batch draws from the
    key's generator, seeded (seed, _TEST, iter, net, batch)."""
    sp = _write(tmp_path, NOISY, test_iter=3, test_interval=0)
    a = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    b = TGS(sp, feeds=_mlp_feeds(), device="cpu")
    for gs in (a, b):
        gs.step(2)
    got = a._test_means(0, a._test_outputs)
    want = b._test_means(0, b._test_outputs_eager)
    assert got.keys() == want.keys() == {"acc", "loss"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    a.test()
    (stats,) = a.forwards.stats()
    assert stats["key"] == ("test", 0) and stats["calls"] == 6


def test_test_passes_read_the_static_carry_and_equal_jax(tmp_path):
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds(), test_iter=3,
                     test_interval=2)
    jgs.step(4)
    tgs.step(4)
    jt, tt = jgs.test(), tgs.test()
    for k in jt:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5, atol=1e-7)
    # every pass (at 0 and 2 in the steps, this one at 4) went through
    # one key, which reads the runner's carry in place
    (stats,) = tgs.forwards.stats()
    assert stats["calls"] == 3 * 3
    p, _ = tgs._shared_test_trees(0)
    assert p["fc1"]["w"] is tgs.runner.carry[0]["fc1"]["w"]


# ------------------------------------------ weights replaced mid-run vs JAX

def test_restore_mid_run_then_steps_equal_jax(tmp_path):
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds(), snapshot=3, max_iter=9)
    jgs.step(3)                                   # writes s_iter_3
    tgs.step(2)
    runner = tgs.runner
    assert tgs.restore(str(tmp_path / "s_iter_3.solverstate")) == 3
    jgs.step(3)
    tgs.step(3)
    assert tgs.runner is runner                   # copied into its carry
    _trees_close(tgs.params, jgs.params)
    _trees_close(tgs.opt_state, jgs.opt_state)


def test_copy_weights_mid_run_then_steps_equal_jax(tmp_path):
    other = tmp_path / "other"
    other.mkdir()
    jw = JGS(_write(other, MLP, base_lr=0.2), feeds=_mlp_feeds(seed=5))
    jw.step(4)
    model, _ = jw.snapshot()
    jgs, tgs = _pair(tmp_path, MLP, _mlp_feeds())
    jgs.step(2)
    tgs.step(2)
    jgs.copy_weights(model)
    report = tgs.copy_weights(model)
    assert set(report.values()) == {"loaded"}
    tgs.step(2)
    jgs.step(2)
    _trees_close(tgs.params, jgs.params)
    _trees_close(tgs.opt_state, jgs.opt_state)


# --------------------------------------------------------- pycaffe

@pytest.fixture
def cpu_mode():
    tcaffe.set_mode_cpu()
    yield
    set_pycaffe_mode("gpu")


def test_net_forwards_move_bn_in_place_and_equal_jax(tmp_path, cpu_mode):
    """Two train-phase forwards of the NetSpec V4 net: the BN statistics
    move in place, so the second forward reuses the first one's key."""
    j, t, ins = _v4_pair(tmp_path, "train")
    state = t.state
    for _ in range(2):
        jo, to = j.forward(**ins), t.forward(**ins)
        assert list(to) == list(jo)
        for k in j.blobs:
            _close_rel(np.asarray(t.blobs[k]), np.asarray(j.blobs[k]),
                       BLOB_RTOL, k)
    assert t.state is state
    for name, want in _named(_np(j.state)).items():
        _close_rel(_named(t.state)[name], want, BLOB_RTOL, name)
    (stats,) = t.forwards.stats()
    assert stats["key"] == ("forward", "train", None, None)
    assert stats["calls"] == 2


@pytest.mark.parametrize("start,end", [(None, "fc1"), ("relu1", "fc2")])
def test_partial_forwards_keep_a_key_each_and_equal_jax(start, end,
                                                        cpu_mode):
    j, t, ins = _mlp_pair()
    j.forward(**ins)
    t.forward(**ins)
    for _ in range(2):
        jo = j.forward(start=start, end=end)
        to = t.forward(start=start, end=end)
        assert list(to) == list(jo)
        for k in jo:
            np.testing.assert_allclose(np.asarray(to[k]), np.asarray(jo[k]),
                                       rtol=1e-5, atol=1e-7)
    got = {s["key"][2:]: s["calls"] for s in t.forwards.stats()}
    assert got == {(None, None): 1, (start, end): 2}


def test_param_writes_then_forward_equal_jax(cpu_mode):
    """An in-place write into a param tensor is read by the same graph;
    assigning ``params`` drops the graphs and reads the new trees."""
    j, t, ins = _mlp_pair()
    j.forward(**ins)
    t.forward(**ins)
    rng = np.random.default_rng(9)
    w = rng.normal(size=np.shape(j.params["fc1"]["w"])).astype(np.float32)
    t.params["fc1"]["w"].data[...] = torch.from_numpy(w)
    j.params = {**j.params, "fc1": {**j.params["fc1"],
                                    "w": jnp.asarray(w)}}
    jo, to = j.forward(**ins), t.forward(**ins)
    np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]),
                               rtol=1e-5)
    assert [s["calls"] for s in t.forwards.stats()] == [2]
    b = rng.normal(size=np.shape(j.params["fc2"]["b"])).astype(np.float32)
    t.params = {**t.params, "fc2": {**t.params["fc2"], "b": b}}
    j.params = {**j.params, "fc2": {**j.params["fc2"],
                                    "b": jnp.asarray(b)}}
    assert t.forwards.keys() == []                     # dropped
    jo, to = j.forward(**ins), t.forward(**ins)
    np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]),
                               rtol=1e-5)


def test_solver_net_forward_writes_bn_into_the_carry_and_equals_jax(
        tmp_path, cpu_mode):
    (tmp_path / "net.prototxt").write_text(
        netspec_v4(tcaffe, V4_STILL, xavier=True))
    sp = _write(tmp_path, (tmp_path / "net.prototxt").read_text(),
                type='"AdaDelta"', base_lr=1.0, momentum=0.95, delta=1e-6)
    j = jcaffe.get_solver(sp, feeds=_qa_feeds())
    t = tcaffe.get_solver(sp, feeds=_qa_feeds())
    _carry(j._gs, t._gs)
    j.step(2)
    t.step(2)
    static_bn = t._gs.runner.carry[1]["bn0"]["mean"]
    for _ in range(2):
        jo, to = j.net.forward(), t.net.forward()
        for k in jo:
            _close_rel(np.asarray(to[k]), np.asarray(jo[k]), BLOB_RTOL, k)
    band = 2 * 3 * 2 * (1e-6 / 0.05) ** 0.5
    _trees_close(t._gs.state, j._gs.state, ("bn0.mean", "bn1.mean"), band)
    assert t._gs.state["bn0"]["mean"] is static_bn     # written in place
    j.step(1)
    t.step(1)
    _trees_close(t.net.params, j.net.params, ("conv0.b", "conv1.b"), band)
    assert [s["calls"] for s in t._gs.forwards.stats()] == [2]


# ------------------------------------------------- GraphedCall generators

def test_graphed_call_seeds_its_generators_before_each_call():
    calls = GraphedCall("cpu", name="draws")

    def draw(x, generators):
        return x + torch.rand(x.shape, generator=generators[0])

    x = torch.zeros(5)
    first = calls(("draw",), draw, x, generators=(11,))
    assert torch.equal(calls(("draw",), draw, x, generators=(11,)), first)
    other = calls(("draw",), draw, x, generators=(12,))
    want = torch.rand(5, generator=torch.Generator().manual_seed(12))
    assert torch.equal(other, want)
    assert len(calls.keys()) == 1
    # a key without generators is a key of its own, called as before
    assert torch.equal(calls(("draw",), lambda y: y + 1, x), x + 1)
    assert len(calls.keys()) == 2


def test_graphed_call_outputs_never_alias_its_static_inputs():
    """An output that is (a view of) a static input is copied, so the
    key's next call leaves it as it was."""
    calls = GraphedCall("cpu", name="echo")
    first = calls(("echo",), lambda a: {"a": a, "v": a[1:]},
                  np.arange(4.0))
    calls(("echo",), lambda a: {"a": a, "v": a[1:]}, np.zeros(4))
    assert first["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert first["v"].tolist() == [1.0, 2.0, 3.0]


# ---------------------------------------------------- nettest, extract

def test_extract_features_iterations_keep_their_batches(tmp_path, capsys,
                                                       monkeypatch):
    """Each iteration's outputs are the host's own: the input blob of
    three batches is the three batches, and a random DummyData blob draws
    anew each iteration, as the eager loop draws."""
    from mms_answer_selection_tpu_torch import cli as tcli
    from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
    from mms_answer_selection_tpu_torch.utils.seed import derive_seed

    rows = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
    net = """
    layer { name: "data" type: "MemoryData" top: "data" top: "label"
      memory_data_param { batch_size: 2 } }
    layer { name: "noise" type: "DummyData" top: "noise"
      dummy_data_param { shape { dim: 2 dim: 4 }
        data_filler { type: "uniform" } } }
    layer { name: "mix" type: "Eltwise" bottom: "data" bottom: "noise"
      top: "mix" }
    """
    (tmp_path / "net.prototxt").write_text(net)

    def batches():
        return ({"data": rows[i:i + 2], "label": np.zeros(2, np.float32)}
                for i in range(0, 6, 2))

    monkeypatch.setattr(tcli, "_test_feeds",
                        lambda *_: [iter(batches())])
    tcli.main(["extract_features", "--model", str(tmp_path / "net.prototxt"),
               "--blobs", "data,mix", "--iterations", "3", "--out",
               str(tmp_path / "f"), "--device", "cpu"])
    capsys.readouterr()
    np.testing.assert_array_equal(np.load(tmp_path / "f" / "data.npy"),
                                  rows)
    mix = np.load(tmp_path / "f" / "mix.npy")
    g = GraphNet(net, phase="test")
    gen = torch.Generator()
    for i, b in enumerate(batches()):
        gen.manual_seed(derive_seed(0, 0xFEA7, i))
        blobs, _ = g.apply({}, {}, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, generator=gen)
        np.testing.assert_array_equal(mix[2 * i:2 * i + 2],
                                      blobs["mix"].numpy())
