"""The NetSpec DSL of the port (``utils/netspec.py``) against the JAX
package's, on CPU.

The same NetSpec calls must write exactly the JAX package's prototxt
text: the cases of ``tests/test_netspec.py`` (its QA fragment included),
the V4 recipe's train and test nets as the QA script's ``make_net`` writes
them (``chip_smoke.netspec_v4``), the database nets of the smoke, and the
pycaffe tutorial net of ``examples/pycaffe_port.py``.  The nets written
run through both packages' GraphNets on the same weights (carried by
``convert.params_from_numpy``): blobs within 1e-5 of each blob's largest
value, float32 sums in another order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import db_net, netspec_v4
from mms_answer_selection_tpu import caffe_compat as jcaffe
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.models.graph_net import GraphNet as JNet
from mms_answer_selection_tpu.utils import netspec as jns
from mms_answer_selection_tpu_torch import caffe_compat as tcaffe
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models.graph_net import GraphNet as TNet
from mms_answer_selection_tpu_torch.utils import netspec as tns
from mms_answer_selection_tpu_torch.utils.prototxt import parse_prototxt

BLOB_RTOL = 1e-5


def _ip(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.ip = ns.L.InnerProduct(n.x, num_output=10,
                             weight_filler=dict(type="xavier"))
    return n.to_prototxt()


def _layer_fields(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.c = ns.L.Convolution(n.x, num_output=4, kernel_size=3,
                           param=[dict(name="shared_w", lr_mult=1),
                                  dict(lr_mult=2, decay_mult=0)])
    return n.to_prototxt()


def _enum(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.p = ns.L.Pooling(n.x, pool=ns.P.Pooling.MAX, kernel_size=2, stride=2)
    return n.to_prototxt()


def _multi_top(ns):
    n = ns.NetSpec()
    n.question, n.answer, n.label = ns.L.HDF5Data(
        batch_size=50, source="train.txt", shuffle=1, ntop=3)
    return n.to_prototxt()


def _in_place(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.relu = ns.L.ReLU(n.x, in_place=True)
    return n.to_prototxt()


def _sink(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.sink = ns.L.Silence(n.x, ntop=0)
    return n.to_prototxt()


def _autonames(ns):
    x = ns.L.Input()
    h = ns.L.TanH(x)
    return ns.to_prototxt(ns.L.TanH(h))


def _scalar_to_repeated(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.s1, n.s2 = ns.L.Slice(n.x, axis=1, slice_point=2, ntop=2)
    return n.to_prototxt()


def _merge(ns):
    shared = dict(num_output=5)
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.c1 = ns.L.Convolution(n.x, kernel_size=3, convolution_param=shared)
    n.c2 = ns.L.Convolution(n.x, convolution_param=shared, kernel_size=7)
    assert shared == {"num_output": 5}
    return str(n.to_proto())


def _mlp(ns):
    n = ns.NetSpec()
    n.x = ns.L.Input()
    n.label = ns.L.Input()
    n.ip1 = ns.L.InnerProduct(n.x, num_output=8,
                              weight_filler=dict(type="xavier"))
    n.t1 = ns.L.TanH(n.ip1, in_place=True)
    n.ip2 = ns.L.InnerProduct(n.ip1, num_output=3,
                              weight_filler=dict(type="xavier"))
    n.loss = ns.L.SoftmaxWithLoss(n.ip2, n.label)
    return n.to_prototxt(name="mlp")


def _qa_fragment(ns):
    """tests/test_netspec.py:148: the QA script's make_net shape."""
    n = ns.NetSpec()
    n.question = ns.L.Input()
    n.answer = ns.L.Input()
    shared = [dict(name="embed-weights"), dict(name="embed-bias")]
    n.w2v_q = ns.L.Embed(n.question, num_output=8, input_dim=30,
                         param=shared,
                         weight_filler=dict(type="uniform", min=-1, max=1))
    n.w2v_a = ns.L.Embed(n.answer, num_output=8, input_dim=30,
                         param=shared,
                         weight_filler=dict(type="uniform", min=-1, max=1))
    n.sim = ns.L.SimCross(n.w2v_q, n.w2v_a, dist_mode=2, mesure_count=2)
    n.pool = ns.L.Pooling(n.sim, pool=ns.P.Pooling.MAX, global_pooling=True)
    return n.to_prototxt()


def _tutorial(ns):
    """examples/pycaffe_port.py's make_net."""
    n = ns.NetSpec()
    n.data, n.label = ns.L.HDF5Data(batch_size=64, source="train.txt",
                                    shuffle=True, ntop=2)
    n.ip1 = ns.L.InnerProduct(n.data, num_output=32,
                              weight_filler={"type": "xavier"})
    n.relu1 = ns.L.ReLU(n.ip1, in_place=True)
    n.ip2 = ns.L.InnerProduct(n.ip1, num_output=3,
                              weight_filler={"type": "xavier"})
    n.loss = ns.L.SoftmaxWithLoss(n.ip2, n.label)
    n.acc = ns.L.Accuracy(n.ip2, n.label)
    return str(n.to_proto())


def _custom(ns):
    ns.register_param_message("MyCustomType", "my_custom_param")
    try:
        n = ns.NetSpec()
        n.x = ns.L.Input()
        n.m = ns.L.MyCustomType(n.x, knob=7)
        return n.to_prototxt()
    finally:
        ns._PARAM_MSG.pop("MyCustomType")


CALLS = [_ip, _layer_fields, _enum, _multi_top, _in_place, _sink,
         _autonames, _scalar_to_repeated, _merge, _mlp, _qa_fragment,
         _tutorial, _custom]


@pytest.mark.parametrize("calls", CALLS, ids=lambda f: f.__name__[1:])
def test_netspec_calls_write_jax_s_text(calls):
    want = calls(jns)
    assert calls(tns) == want
    assert parse_prototxt(want)     # and it parses


V4_SMALL = dataclasses.replace(JQ.V4, vocab_size=120)


@pytest.mark.parametrize("phase", ["train", "test"])
@pytest.mark.parametrize("variant", ["recipe", "xavier", "still"])
def test_v4_recipe_nets_write_jax_s_text(phase, variant):
    cfg = V4_SMALL if variant != "still" else dataclasses.replace(
        V4_SMALL, sim_dropout=0.0, fc1_dropout=0.0)
    kw = dict(phase=phase, xavier=variant == "xavier",
              data="dev" if phase == "test" else "data")
    want = netspec_v4(jcaffe, cfg, **kw)
    assert netspec_v4(tcaffe, cfg, **kw) == want


@pytest.mark.parametrize("head", ["data", "window", "deploy"])
def test_database_nets_write_jax_s_text(head):
    kw = dict(batch=8, phase="test", head=head, deploy=head == "deploy")
    want = db_net(jcaffe, "/db/lmdb", **kw)
    assert db_net(tcaffe, "/db/lmdb", **kw) == want


@pytest.mark.parametrize("phase", ["train", "test"])
def test_v4_recipe_net_equals_net_prototxt_from_config(phase):
    from mms_answer_selection_tpu_torch.utils.prototxt import \
        net_prototxt_from_config

    got = parse_prototxt(netspec_v4(tcaffe, V4_SMALL, phase=phase))
    want = parse_prototxt(net_prototxt_from_config(
        V4_SMALL, phase="eval" if phase == "test" else "train"))
    assert got == want


@pytest.mark.parametrize("bad", ["unroutable", "positional"])
def test_netspec_refuses_what_jax_refuses(bad):
    for ns in (jns, tns):
        if bad == "unroutable":
            n = ns.NetSpec()
            n.x = ns.L.Input()
            with pytest.raises(ValueError, match="no parameter message"):
                n.s = ns.L.Split(n.x, bogus_knob=3)
                n.to_prototxt()
        else:
            with pytest.raises(TypeError, match="must be Tops"):
                ns.L.ReLU(np.zeros((2, 2)))


def test_enum_tokens_are_jax_s():
    assert isinstance(tns.P.Eltwise.SUM, str)
    assert isinstance(tns.P.Eltwise.SUM, tns.Enum)
    assert str(tns.P.Pooling.MAX) == str(jns.P.Pooling.MAX) == "MAX"


def _run_both(text, ins, train):
    jnet, tnet = JNet(text, phase="train"), TNet(text, phase="train")
    jp, js = jnet.init(jax.random.PRNGKey(0), ins)
    tp, ts = params_from_numpy(jax.tree.map(np.asarray, jp),
                               jax.tree.map(np.asarray, js), "cpu")
    jb, _ = jnet.apply(jp, js, ins, train=train)
    with torch.no_grad():
        tb, _ = tnet.apply(tp, ts, {k: torch.as_tensor(np.asarray(v))
                                    for k, v in ins.items()}, train=train)
    assert set(tb) == set(jb)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= BLOB_RTOL * scale, k


@pytest.mark.parametrize("calls", [_mlp, _qa_fragment])
def test_written_nets_run_as_jax_s(calls):
    rng = np.random.default_rng(1)
    if calls is _mlp:
        ins = {"x": rng.normal(size=(6, 5)).astype(np.float32),
               "label": rng.integers(0, 3, (6,)).astype(np.int32)}
    else:
        ins = {"question": rng.integers(0, 30, (4, 7)).astype(np.int32),
               "answer": rng.integers(0, 30, (4, 9)).astype(np.int32)}
    _run_both(calls(tns), ins, train=True)
