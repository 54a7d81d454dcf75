"""The pycaffe surface of the port (``caffe_compat``, ``models/pynet.py``,
``models/pysolver.py``) against the JAX package's, on CPU
(``set_mode_cpu()`` or ``device="cpu"``).

Tolerances, with their reasons:

* a NetSpec V4 net (batch 6, no dropout: the packages' generators draw
  different masks) on one set of weights (the JAX net's, carried as numpy
  into ``Net.params``): every blob within 1e-5 of its largest value, every
  param diff and input diff within 1e-4 of the leaf's largest value (a
  gradient through the whole net, float32 sums in another order).  The
  conv biases feed train-mode BN: their true gradient is 0 and both
  packages give rounding noise (7e-4 of the conv weight diff's largest
  value measured here), held to a band of 1e-2 of it, not to each other.
  In the test phase the BN running variance is set positive in both (at
  init it is 0, and eval-mode BN divides by sqrt(1e-9), magnifying the
  last bits);
* the small MLP's forwards, partial forwards and backwards: rtol 1e-5;
* solver steps: ``tests/test_torch_graph_solver.py``'s tolerances (rtol
  1e-4 on params and history; the V4 net's AdaDelta noise band on the
  conv biases);
* snapshot / restore within the port: bit for bit; a JAX snapshot
  continued in the port: rtol 1e-4, and the weights it loads exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import netspec_v4
from mms_answer_selection_tpu import caffe_compat as jcaffe
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu_torch import caffe_compat as tcaffe
from mms_answer_selection_tpu_torch.device import set_pycaffe_mode
from tests.test_torch_graph_solver import (MLP, _carry, _mlp_feeds, _named,
                                           _np, _qa_feeds, _trees_close,
                                           _write)

h5py = pytest.importorskip("h5py")

BLOB_RTOL, DIFF_RTOL = 1e-5, 1e-4
V4_STILL = dataclasses.replace(JQ.V4, vocab_size=120, sim_dropout=0.0,
                               fc1_dropout=0.0)


@pytest.fixture(autouse=True)
def cpu_mode():
    """pycaffe's mode is global: the CPU for these tests, the default
    (the card) after each."""
    tcaffe.set_mode_cpu()
    yield
    set_pycaffe_mode("gpu")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close_rel(got, want, rtol, what=""):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, what


def _qa_inputs(n=6):
    return {k: v for k, v in _qa_feeds(n)["data"].items()
            if k not in ("batch_size", "shuffle")}


def _v4_pair(tmp_path, phase="train"):
    """The NetSpec V4 net in both packages on the JAX net's weights."""
    text = netspec_v4(jcaffe, V4_STILL, phase=phase, xavier=True)
    assert netspec_v4(tcaffe, V4_STILL, phase=phase, xavier=True) == text
    (tmp_path / "v4.prototxt").write_text(text)
    ins = _qa_inputs()
    if phase != "train":
        ins["group"] = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    j = jcaffe.Net(str(tmp_path / "v4.prototxt"), phase, seed=3)
    j.forward(**ins)
    if phase != "train":
        rng = np.random.default_rng(2)
        j._state = {k: {"mean": np.float32(0.1) * rng.normal(
                            size=v["mean"].shape).astype(np.float32),
                        "var": 1 + rng.random(v["var"].shape,
                                              dtype=np.float32)}
                    for k, v in j.state.items()}
        j._fwd = None
    t = tcaffe.Net(str(tmp_path / "v4.prototxt"), phase)
    t.params = jax.tree.map(np.asarray, j.params)    # numpy straight in
    t.state = jax.tree.map(np.asarray, j.state)
    return j, t, ins


# ------------------------------------------------------------ the net

@pytest.mark.parametrize("phase", ["train", "test"])
def test_netspec_v4_forward_equals_jax(tmp_path, phase):
    j, t, ins = _v4_pair(tmp_path, phase)
    jo, to = j.forward(**ins), t.forward(**ins)
    assert list(to) == list(jo) == t.outputs
    assert set(t.blobs) == set(j.blobs)
    for k in j.blobs:
        _close_rel(np.asarray(t.blobs[k]), np.asarray(j.blobs[k]),
                   BLOB_RTOL, k)


def test_netspec_v4_param_diffs_equal_jax(tmp_path):
    j, t, ins = _v4_pair(tmp_path)
    j.forward(**ins)
    t.forward(**ins)
    jd = j.backward(loss=jnp.ones(()))
    td = t.backward(loss=1.0)
    assert set(td) == set(jd) == {"overlap_feat"}
    _close_rel(td["overlap_feat"], jd["overlap_feat"], DIFF_RTOL)
    np.testing.assert_array_equal(t.blobs["overlap_feat"].diff,
                                  td["overlap_feat"])
    jp, tp = _named(_np(j.param_diffs)), _named(t.param_diffs)
    assert tp.keys() == jp.keys()
    for name, want in jp.items():
        if name in ("conv0.b", "conv1.b"):   # noise under train-mode BN
            band = 1e-2 * float(np.abs(jp[name[:-1] + "w"]).max())
            assert float(np.abs(tp[name]).max()) <= band
            assert float(np.abs(want).max()) <= band
            continue
        _close_rel(tp[name], want, DIFF_RTOL, name)


def test_net_surface_equals_jax(tmp_path):
    j, t, ins = _v4_pair(tmp_path, "test")
    j.forward(**ins)
    t.forward(**ins)
    assert t.layer_names == j.layer_names
    assert t.inputs == j.inputs and t.outputs == j.outputs
    assert t.top_names == j.top_names
    assert t.bottom_names == j.bottom_names
    for a, b in zip(t.layers, j.layers):
        assert (a.name, a.type, len(a.blobs)) == (b.name, b.type,
                                                  len(b.blobs))
        for x, y in zip(a.blobs, b.blobs):
            np.testing.assert_array_equal(x, y)


def _mlp_pair(phase="train", **kw):
    ins = {k: v[:6] for k, v in _mlp_feeds()["data"].items()
           if k not in ("batch_size", "shuffle")}
    j = jcaffe.Net(MLP, phase, seed=1, **kw)
    j.forward(**ins)
    t = tcaffe.Net(MLP, phase)
    t.params = jax.tree.map(np.asarray, j.params)
    return j, t, ins


@pytest.mark.parametrize("start,end", [(None, "fc1"), ("fc2", None),
                                       ("relu1", "fc2"), ("fc2", "loss")])
def test_partial_forward_equals_jax(start, end):
    j, t, ins = _mlp_pair()
    j.forward(**ins)
    t.forward(**ins)
    jo = j.forward(start=start, end=end)
    to = t.forward(start=start, end=end)
    assert list(to) == list(jo)
    for k in jo:
        np.testing.assert_allclose(np.asarray(to[k]), np.asarray(jo[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("start,end", [(None, None), ("fc2", "fc2"),
                                       ("loss", "fc2"), ("fc2", "fc1")])
def test_backward_equals_jax(start, end):
    j, t, ins = _mlp_pair("test")
    j.forward(**ins)
    t.forward(**ins)
    top = "fc2" if start in ("fc2",) else "loss"
    g = np.ones((6, 3), np.float32) if top == "fc2" else 1.0
    jd = j.backward(start=start, end=end, **{top: g})
    td = t.backward(start=start, end=end, **{top: g})
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k], np.asarray(jd[k]), rtol=1e-5,
                                   atol=1e-7)
    for name, want in _named(_np(j.param_diffs)).items():
        np.testing.assert_allclose(_named(t.param_diffs)[name], want,
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_set_input_arrays_equals_jax():
    txt = """
    layer { name: "md" type: "MemoryData" top: "data" top: "label"
      memory_data_param { batch_size: 2 } }
    layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
      inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
    """
    data = np.arange(12, dtype=np.float32).reshape(6, 2)
    labels = np.arange(6, dtype=np.float32)
    j = jcaffe.Net(txt, jcaffe.TEST)
    t = tcaffe.Net(txt, tcaffe.TEST)
    j.set_input_arrays(data, labels)
    t.set_input_arrays(data, labels)
    for i in range(4):
        j.forward()
        t.forward()
        if i == 0:
            t.params = jax.tree.map(np.asarray, j.params)
            t.forward()       # the first batch again, on JAX's weights
            t.set_input_arrays(data, labels)
            t.forward()
        for k in ("data", "label", "fc"):
            np.testing.assert_allclose(t.blobs[k].data, j.blobs[k].data,
                                       rtol=1e-6)
    for net in (j, t):
        with pytest.raises(ValueError, match="multiple"):
            net.set_input_arrays(np.zeros((5, 2), np.float32),
                                 np.zeros(5, np.float32))


def test_blob_idioms_equal_jax():
    j, t, ins = _mlp_pair("test")
    for net in (j, t):
        net.forward(**ins)
        buf = net.blobs["data"].data
        buf[...] = np.asarray(ins["data"]) * 2 + 0.5
        net.forward()
    np.testing.assert_allclose(float(t.blobs["loss"]),
                               float(j.blobs["loss"]), rtol=1e-6)
    assert t.blobs["data"].data is buf       # the held buffer stays live
    b = t.blobs["fc2"]
    assert b.shape == j.blobs["fc2"].shape and b.ndim == 2
    np.testing.assert_allclose(np.asarray(b), np.asarray(j.blobs["fc2"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(b.argmax(1), np.asarray(b).argmax(1))
    np.testing.assert_array_equal(b * 2 + 1, np.asarray(b) * 2 + 1)
    assert b[0, 1] == np.asarray(b)[0, 1] and len(b) == 6
    for blob in (j.blobs["fc2"], t.blobs["fc2"]):
        with pytest.raises(AttributeError, match="backward"):
            _ = blob.diff


def test_written_data_layer_tops_all_feed_from_their_blobs(tmp_path):
    """A departure from the JAX package, on purpose: once the user writes
    into one top of a streaming data layer, every top of that layer feeds
    from its blob, including a top written with its unchanged value (the
    JAX package streams the next batch for a top whose write did not
    change it)."""
    xs = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    with h5py.File(tmp_path / "d.h5", "w") as f:
        f["data"], f["label"] = xs, np.arange(8).astype(np.float64)
    (tmp_path / "d.txt").write_text(str(tmp_path / "d.h5") + "\n")
    text = (f'layer {{ name: "d" type: "HDF5Data" top: "data" top: "label" '
            f'hdf5_data_param {{ source: "{tmp_path / "d.txt"}" '
            f'batch_size: 2 }} }}\n'
            'layer { name: "fc" type: "InnerProduct" bottom: "data" '
            'top: "fc" inner_product_param { num_output: 2 } }\n')
    net = tcaffe.Net(text, tcaffe.TEST)
    net.forward()
    net.blobs["data"].data[...] = 7.0
    net.blobs["label"].data[...] = net.blobs["label"].data  # unchanged
    net.forward()
    np.testing.assert_array_equal(net.blobs["label"].data, [0, 1])
    np.testing.assert_array_equal(net.blobs["data"].data, 7.0)
    net.forward()                       # no write: the layer streams on
    np.testing.assert_array_equal(net.blobs["label"].data, [2, 3])


def test_save_and_copy_from_across_packages(tmp_path):
    j, t, ins = _mlp_pair("test")
    j.save(str(tmp_path / "j.caffemodel"))
    fresh = tcaffe.Net(MLP, tcaffe.TEST,
                       weights=str(tmp_path / "j.caffemodel"))
    np.testing.assert_allclose(float(fresh.forward(**ins)["loss"]),
                               float(j.forward(**ins)["loss"]), rtol=1e-6)
    t.forward(**ins)
    t.params = {k: {n: v * 1.5 for n, v in sub.items()}
                for k, sub in t.params.items()}
    t.save(str(tmp_path / "t.caffemodel"))
    back = jcaffe.Net(MLP, jcaffe.TEST, seed=9)
    back.forward(**ins)
    back.copy_from(str(tmp_path / "t.caffemodel"))
    for name, x in _named(t.params).items():
        np.testing.assert_array_equal(_named(_np(back.params))[name], x)


# ----------------------------------------------------------- the solvers

SOLVER_CLASSES = ["SGDSolver", "NesterovSolver", "AdaGradSolver",
                  "RMSPropSolver", "AdaDeltaSolver", "AdamSolver"]


@pytest.mark.parametrize("cls", SOLVER_CLASSES)
def test_typed_solver_steps_equal_jax(tmp_path, cls):
    sp = _write(tmp_path, MLP, base_lr=0.05, delta=1e-6, momentum=0.9)
    j = getattr(jcaffe, cls)(sp, feeds=_mlp_feeds())
    t = getattr(tcaffe, cls)(sp, feeds=_mlp_feeds())
    assert t._gs.cfg.solver_type == j._gs.cfg.solver_type
    assert t._gs.device.type == "cpu"
    _carry(j._gs, t._gs)
    j.step(5)
    t.step(5)
    assert t.iter == j.iter == 5
    _trees_close(t.net.params, j.net.params)
    _trees_close(t._gs.opt_state, j._gs.opt_state)
    np.testing.assert_allclose(float(t.net.blobs["loss"]),
                               float(j.net.blobs["loss"]), rtol=1e-5)


def test_netspec_v4_adadelta_steps_equal_jax(tmp_path):
    """The recipe's update rule on the NetSpec V4 net from a xavier W."""
    (tmp_path / "net.prototxt").write_text(
        netspec_v4(tcaffe, V4_STILL, xavier=True))
    sp = _write(tmp_path, (tmp_path / "net.prototxt").read_text(),
                type='"AdaDelta"', base_lr=1.0, momentum=0.95, delta=1e-6)
    j = jcaffe.get_solver(sp, feeds=_qa_feeds())
    t = tcaffe.get_solver(sp, feeds=_qa_feeds())
    _carry(j._gs, t._gs)
    j.step(3)
    t.step(3)
    band = 2 * 3 * 2 * (1e-6 / 0.05) ** 0.5
    _trees_close(t.net.params, j.net.params, ("conv0.b", "conv1.b"), band)
    _trees_close(t._gs.state, j._gs.state, ("bn0.mean", "bn1.mean"), band)
    hist = [r["loss"] for r in t.history]
    np.testing.assert_allclose(hist, [r["loss"] for r in j.history],
                               rtol=1e-5)


def test_test_net_view_shares_weights_and_equals_jax(tmp_path):
    sp = _write(tmp_path, MLP, test_iter=1, test_interval=0)
    j = jcaffe.get_solver(sp, feeds=_mlp_feeds())
    t = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    _carry(j._gs, t._gs)
    j.step(4)
    t.step(4)
    tv = t.test_nets[0]
    assert tv.params["fc1"]["w"] is t.net.params["fc1"]["w"]
    jo, to = j.test_nets[0].forward(), tv.forward()
    for k in jo:
        np.testing.assert_allclose(float(to[k]), float(jo[k]), rtol=1e-5)
    with pytest.raises(AttributeError, match="share"):
        tv.params = t.net.params


def test_snapshot_restore_bit_for_bit(tmp_path):
    sp = _write(tmp_path, MLP, max_iter=6, snapshot_format="BINARYPROTO")
    a = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    a.step(3)
    model, state = a.snapshot()
    a.step(3)
    b = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    assert b.restore(state) == 3 and b.iter == 3
    b.step(3)
    for name, x in _named(a.net.params).items():
        np.testing.assert_array_equal(_named(b.net.params)[name], x)
    for name, x in _named(a._gs.opt_state).items():
        np.testing.assert_array_equal(_named(b._gs.opt_state)[name], x)
    with pytest.raises(FileNotFoundError):
        b.restore(str(tmp_path / "nope.solverstate"))


@pytest.mark.parametrize("fmt", ["BINARYPROTO", "HDF5"])
def test_jax_snapshot_continues_in_the_port(tmp_path, fmt):
    sp = _write(tmp_path, MLP, max_iter=6, snapshot_format=fmt)
    j = jcaffe.get_solver(sp, feeds=_mlp_feeds())
    j.step(3)
    model, state = j.snapshot()
    t = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    t.restore(state)
    for name, x in _named(_np(j.net.params)).items():
        np.testing.assert_array_equal(_named(t.net.params)[name], x)
    j.step(3)
    t.step(3)
    _trees_close(t.net.params, j.net.params)
    _trees_close(t._gs.opt_state, j._gs.opt_state)


def test_port_snapshot_continues_in_jax(tmp_path):
    sp = _write(tmp_path, MLP, max_iter=6)
    t = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    t.step(3)
    model, state = t.snapshot()
    j = jcaffe.get_solver(sp, feeds=_mlp_feeds())
    j.restore(state)
    assert j.iter == 3
    t.step(3)
    j.step(3)
    _trees_close(t.net.params, j.net.params)
    net = jcaffe.Net(MLP, jcaffe.TEST)
    net.forward(**{k: v[:4] for k, v in _mlp_feeds()["data"].items()
                   if k not in ("batch_size", "shuffle")})
    net.copy_from(model)


def test_solver_view_save_and_callbacks(tmp_path):
    sp = _write(tmp_path, MLP)
    t = tcaffe.get_solver(sp, feeds=_mlp_feeds())
    calls = []
    t.add_callback(lambda: calls.append("start"),
                   lambda: calls.append("ready"))
    t.step(2)
    assert calls == ["start", "ready"] * 2
    t.net.save(str(tmp_path / "v.caffemodel"))
    j = jcaffe.get_solver(sp, feeds=_mlp_feeds())
    j.net.copy_from(str(tmp_path / "v.caffemodel"))
    for name, x in _named(t.net.params).items():
        np.testing.assert_array_equal(_named(_np(j.net.params))[name], x)
    out = t.net.forward()
    assert set(out) == set(j.net.forward())
    assert {"data", "fc1", "fc2", "loss"} <= set(t.net.blobs)


# ------------------------------------------------------- the namespace

def test_namespace_exports_jax_s_names():
    assert tcaffe.__all__ == jcaffe.__all__
    for name in jcaffe.__all__:
        assert hasattr(tcaffe, name), name
    assert (tcaffe.TRAIN, tcaffe.TEST) == (jcaffe.TRAIN, jcaffe.TEST)
    from mms_answer_selection_tpu_torch.caffe_compat.proto import caffe_pb2

    assert caffe_pb2 is tcaffe.proto.caffe_pb2
    assert caffe_pb2.Datum(label=3).SerializeToString() == \
        jcaffe.proto.caffe_pb2.Datum(label=3).SerializeToString()
    assert tcaffe.layer_type_list() == jcaffe.layer_type_list()


def test_net_constructor_shapes(tmp_path):
    j, t, ins = _mlp_pair("test")
    t.save(str(tmp_path / "w.caffemodel"))
    for args, kw in (((str(tmp_path / "w.caffemodel"), tcaffe.TEST), {}),
                     ((tcaffe.TEST,), {"weights": str(tmp_path /
                                                      "w.caffemodel")})):
        (tmp_path / "m.prototxt").write_text(MLP)
        net = tcaffe.Net(str(tmp_path / "m.prototxt"), *args, **kw)
        net.forward(**ins)
        for name, x in _named(t.params).items():
            np.testing.assert_array_equal(_named(net.params)[name], x)
    with pytest.raises(TypeError, match="twice"):
        tcaffe.Net(MLP, "w", tcaffe.TEST, weights="x")


def test_set_mode_routes_nets_and_solvers(tmp_path):
    sp = _write(tmp_path, MLP)
    tcaffe.set_mode_cpu()
    assert tcaffe.Net(MLP).device.type == "cpu"
    assert tcaffe.get_solver(sp, feeds=_mlp_feeds())._gs.device.type \
        == "cpu"
    tcaffe.set_mode_gpu()
    tcaffe.set_device(0)
    if not torch.cuda.is_available():
        for make in (lambda: tcaffe.Net(MLP),
                     lambda: tcaffe.get_solver(sp, feeds=_mlp_feeds())):
            with pytest.raises(RuntimeError, match="cuda"):
                make()
    # an explicit device wins over the mode
    assert tcaffe.Net(MLP, device="cpu").device.type == "cpu"
    assert tcaffe.SGDSolver(sp, feeds=_mlp_feeds(),
                            device="cpu")._gs.device.type == "cpu"


# ----------------------------------------------------- the tutorial flow

def test_pycaffe_port_example_flow(tmp_path):
    """examples/pycaffe_port.py's flow with the port's namespace: NetSpec
    -> get_solver -> step while reading blobs -> snapshot -> restore ->
    caffe.Net on the snapshot, its data from h5py in ``tmp_path``."""
    caffe = tcaffe
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 3))
    xs = rng.normal(size=(512, 8)).astype(np.float32)
    ys = np.argmax(xs @ w, axis=1).astype(np.float64)
    with h5py.File(tmp_path / "train.h5", "w") as f:
        f["data"], f["label"] = xs, ys
    (tmp_path / "train.txt").write_text(str(tmp_path / "train.h5") + "\n")
    n = caffe.NetSpec()
    n.data, n.label = caffe.layers.HDF5Data(
        batch_size=64, source=str(tmp_path / "train.txt"), shuffle=True,
        ntop=2)
    n.ip1 = caffe.layers.InnerProduct(n.data, num_output=32,
                                      weight_filler={"type": "xavier"})
    n.relu1 = caffe.layers.ReLU(n.ip1, in_place=True)
    n.ip2 = caffe.layers.InnerProduct(n.ip1, num_output=3,
                                      weight_filler={"type": "xavier"})
    n.loss = caffe.layers.SoftmaxWithLoss(n.ip2, n.label)
    n.acc = caffe.layers.Accuracy(n.ip2, n.label)
    (tmp_path / "net.prototxt").write_text(str(n.to_proto()))
    (tmp_path / "solver.prototxt").write_text(
        f'net: "{tmp_path}/net.prototxt"\nbase_lr: 0.1\nlr_policy: "inv"\n'
        'gamma: 0.0001\npower: 0.75\nmomentum: 0.9\nmax_iter: 500\n'
        f'display: 100\nsnapshot_prefix: "{tmp_path}/lenet"\n'
        'snapshot_format: HDF5\nrandom_seed: 7\n')
    caffe.set_mode_cpu()
    solver = caffe.get_solver(str(tmp_path / "solver.prototxt"))
    losses = []
    for _ in range(5):
        solver.step(100)
        losses.append(float(solver.net.blobs["loss"].data))
    assert losses[-1] < losses[0]
    assert float(solver.net.blobs["acc"].data) > 0.9
    model_path, state_path = solver.snapshot()
    assert model_path.endswith(".caffemodel.h5")
    solver2 = caffe.get_solver(str(tmp_path / "solver.prototxt"))
    solver2.restore(state_path)
    assert solver2.iter == solver.iter == 500
    np.testing.assert_array_equal(
        np.asarray(solver.net.params["ip1"]["w"]),
        np.asarray(solver2.net.params["ip1"]["w"]))
    net = caffe.Net(str(tmp_path / "net.prototxt"), caffe.TEST,
                    weights=model_path)
    assert float(net.forward()["acc"]) > 0.9
    # the JAX package reads the port's snapshot into its own Net
    jnet = jcaffe.Net(str(tmp_path / "net.prototxt"), jcaffe.TEST,
                      weights=model_path)
    np.testing.assert_allclose(float(jnet.forward()["acc"]),
                               float(caffe.Net(
                                   str(tmp_path / "net.prototxt"),
                                   caffe.TEST, weights=model_path)
                                   .forward()["acc"]), rtol=1e-6)
    assert os.path.exists(state_path)
