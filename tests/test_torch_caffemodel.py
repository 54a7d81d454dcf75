"""The reference's weight files in the port against the JAX package's:
``.caffemodel`` (binaryproto and HDF5), ``.solverstate`` (both) and the
mean-file BlobProto.

For the same trees both packages must write the same bytes, and a file
either package writes must load into the other with the same values.  The
comparisons are exact (bytes, and float32 values bit for bit).  The trees
are the typed V4 model (its family spec) and generic GraphNets (their
``caffemodel_specs``), every leaf made distinctive.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import graph_net as JGN
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.utils import caffemodel as JCM
from mms_answer_selection_tpu.utils.prototxt import net_prototxt_from_config
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.data import pair_image as TD
from mms_answer_selection_tpu_torch.models import graph_net as TGN
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.utils import caffemodel as TCM

ZOO = """
name: "interopzoo"
layer { name: "in" type: "Input" top: "x" top: "q" top: "r" top: "s" }
layer { name: "pvec" type: "Parameter" top: "pv"
  parameter_param { shape { dim: 5 } } }
layer { name: "dc" type: "Deconvolution" bottom: "x" top: "dx"
  convolution_param { num_output: 2 kernel_size: 2 stride: 2
    weight_filler { type: "gaussian" std: 0.5 } } }
layer { name: "cv" type: "Convolution" bottom: "dx" top: "cx"
  convolution_param { num_output: 3 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.5 } } }
layer { name: "bn" type: "BN" bottom: "cx" top: "bx" }
layer { name: "bnm" type: "BatchNorm" bottom: "bx" top: "by" }
layer { name: "sc" type: "Scale" bottom: "by" top: "sx"
  scale_param { bias_term: true } }
layer { name: "sc2" type: "Scale" bottom: "q" bottom: "pv" top: "s2"
  scale_param { bias_term: true } }
layer { name: "bi" type: "Bias" bottom: "s2" top: "bz" }
layer { name: "sm" type: "SimMatrix" bottom: "q" bottom: "r" top: "sm" }
layer { name: "ip" type: "InnerProduct" bottom: "sx" top: "ip"
  inner_product_param { num_output: 4 } }
layer { name: "ls" type: "LSTM" bottom: "s" top: "ls"
  recurrent_param { num_output: 3 } }
layer { name: "rn" type: "RNN" bottom: "s" top: "rn"
  recurrent_param { num_output: 2 } }
layer { name: "pr" type: "PReLU" bottom: "ls" top: "pr" }
layer { name: "fm" type: "FM" bottom: "ls" top: "fm" }
layer { name: "em" type: "Embed" bottom: "q" top: "em"
  embed_param { num_output: 2 input_dim: 5 } }
layer { name: "em2" type: "Embed" bottom: "r" top: "em2"
  param { name: "shared" } param { name: "shared-b" }
  embed_param { num_output: 2 input_dim: 5 } }
layer { name: "em3" type: "Embed" bottom: "q" top: "em3"
  param { name: "shared" } param { name: "shared-b" }
  embed_param { num_output: 2 input_dim: 5 } }
"""


def _distinct(tree, rng):
    """Every float leaf replaced by fresh normal draws, as numpy."""
    return jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), jax.device_get(tree))


def _zoo_inputs():
    rng = np.random.default_rng(3)
    return {"x": rng.normal(size=(2, 4, 4, 3)).astype(np.float32),
            "q": rng.normal(size=(2, 5)).astype(np.float32),
            "r": rng.normal(size=(2, 5)).astype(np.float32),
            "s": rng.normal(size=(3, 2, 4)).astype(np.float32)}


def _v4_trees(rng):
    cfg = dataclasses.replace(JQ.V4, vocab_size=50)
    jp, js = JQ.mms_qa_init(jax.random.PRNGKey(0), cfg)
    return _distinct(jp, rng), _distinct(js, rng)


def _zoo_trees(rng):
    ins = _zoo_inputs()
    jnet, tnet = JGN.GraphNet(ZOO), TGN.GraphNet(ZOO)
    jp, js = jnet.init(jax.random.PRNGKey(0),
                       {k: jnp.asarray(v) for k, v in ins.items()})
    jp, js = _distinct(jp, rng), _distinct(js, rng)
    tp, ts = params_from_numpy(jp, js, "cpu")
    return (jp, js, jnet.caffemodel_specs(jp, js)), \
        (tp, ts, tnet.caffemodel_specs(tp, ts))


def _opt(params, rng, accs=("h", "h2")):
    return {a: _distinct(params, rng) for a in accs}


def _both(kind, rng):
    """(JAX trees + specs, port trees + specs) of one kind of net."""
    if kind == "v4":
        jp, js = _v4_trees(rng)
        tp, ts = params_from_numpy(jp, js, "cpu")
        return (jp, js, None), (tp, ts, None)
    return _zoo_trees(rng)


def _assert_tree_equal(t_tree, j_tree, what):
    for k, v in j_tree.items():
        if isinstance(v, dict):
            _assert_tree_equal(t_tree[k], v, f"{what}/{k}")
        else:
            t = t_tree[k]
            assert isinstance(t, torch.Tensor), (what, k)
            np.testing.assert_array_equal(t.numpy(), np.asarray(v),
                                          err_msg=f"{what}/{k}")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["binaryproto", "h5"])
@pytest.mark.parametrize("kind", ["v4", "zoo"])
def test_caffemodel_bytes_and_loads_match(tmp_path, kind, fmt):
    rng = np.random.default_rng(1)
    (jp, js, jspec), (tp, ts, tspec) = _both(kind, rng)
    save_j = getattr(JCM, f"save_caffemodel_{fmt}")
    save_t = getattr(TCM, f"save_caffemodel_{fmt}")
    jpath, tpath = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    save_j(jpath, jp, js, specs=jspec)
    save_t(tpath, tp, ts, specs=tspec)
    assert _bytes(tpath) == _bytes(jpath)
    # a fresh (zero) port tree takes the JAX file's values, by auto-dispatch
    zp = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
          for k, v in tp.items()}
    zs = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
          for k, v in ts.items()}
    zspec = None if tspec is None else TGN.GraphNet(ZOO).caffemodel_specs(
        zp, zs)
    lp, ls, report = TCM.load_caffemodel_auto(jpath, zp, zs, specs=zspec)
    _assert_tree_equal(lp, jp, "params")
    _assert_tree_equal(ls, js, "state")
    assert set(report.values()) <= {"loaded", "absent (shared param)"}
    # and the JAX package loads the port's file to the same values
    jlp, jls, _ = JCM.load_caffemodel_auto(
        tpath, jax.tree.map(np.zeros_like, jp),
        jax.tree.map(np.zeros_like, js), specs=jspec)
    for a, b in zip(jax.tree.leaves((jlp, jls)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("fmt", ["binaryproto", "h5"])
@pytest.mark.parametrize("kind", ["v4", "zoo"])
@pytest.mark.parametrize("accs", [("h",), ("h", "h2")])
def test_solverstate_bytes_and_loads_match(tmp_path, kind, fmt, accs):
    rng = np.random.default_rng(2)
    (jp, js, jspec), (tp, ts, tspec) = _both(kind, rng)
    jo = _opt(jp, rng, accs)
    to = params_from_numpy(jo, {}, "cpu")[0]
    save_j = getattr(JCM, f"save_solverstate_{fmt}")
    save_t = getattr(TCM, f"save_solverstate_{fmt}")
    jpath, tpath = str(tmp_path / "j.state"), str(tmp_path / "t.state")
    kw = dict(current_step=3, learned_net="x_iter_7.caffemodel")
    save_j(jpath, jp, js, jo, 7, specs=jspec, **kw)
    save_t(tpath, tp, ts, to, 7, specs=tspec, **kw)
    assert _bytes(tpath) == _bytes(jpath)
    zo = {a: {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
              for k, v in to[a].items()} for a in accs}
    lo, it, cur, learned, report = TCM.load_solverstate(
        jpath, tp, ts, zo, specs=tspec)
    assert (it, cur, learned) == (7, 3, "x_iter_7.caffemodel")
    _assert_tree_equal(lo, jo, "opt")
    jlo, jit_, *_ = JCM.load_solverstate(
        tpath, jp, js, jax.tree.map(np.zeros_like, jo), specs=jspec)
    assert jit_ == 7
    for a, b in zip(jax.tree.leaves(jlo), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # a family mismatch (wrong accumulator count) is refused
    with pytest.raises(ValueError, match="history length"):
        TCM.load_solverstate(jpath, tp, ts, {"h": to["h"], "h2": to["h"],
                                             "x": to["h"]} if len(accs) == 1
                             else {"h": to["h"]}, specs=tspec)


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("shape", [(3, 4, 5), (1, 2, 3, 4), (6,)])
def test_mean_binaryproto_matches(tmp_path, legacy, shape):
    arr = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    JCM.save_blob_binaryproto(jpath, arr, legacy_dims=legacy)
    TCM.save_blob_binaryproto(tpath, arr, legacy_dims=legacy)
    assert _bytes(tpath) == _bytes(jpath)
    np.testing.assert_array_equal(TCM.load_blob_binaryproto(jpath),
                                  JCM.load_blob_binaryproto(jpath))
    # the image pipeline's mean_file reader is the same reader
    np.testing.assert_array_equal(TD.load_blob_binaryproto(jpath),
                                  TCM.load_blob_binaryproto(jpath))
    if len(shape) == 3 and legacy:
        np.testing.assert_array_equal(TD.load_mean_hwc(jpath),
                                      arr.transpose(1, 2, 0))


def test_generic_net_file_loads_into_the_typed_tree(tmp_path):
    """Weights a generic V4 GraphNet saved through its own specs load into
    the typed V4 tree through the family spec, on the port's side (the
    two speak one format, net.cpp:847-913)."""
    cfg = dataclasses.replace(TQ.V4, vocab_size=60)
    net = TGN.GraphNet(net_prototxt_from_config(cfg), phase="train")
    rng = np.random.default_rng(0)
    batch = {"question": rng.integers(0, 60, (4, 40)),
             "answer": rng.integers(0, 60, (4, 40)),
             "label": rng.integers(0, 2, (4,)),
             "overlap_feat": rng.normal(size=(4, 2)).astype(np.float32)}
    params, state = net.init(torch.Generator().manual_seed(1), batch,
                             device="cpu")
    params = params_from_numpy(_distinct(
        jax.tree.map(lambda t: t.numpy(), params), rng), {}, "cpu")[0]
    specs = net.caffemodel_specs(params, state)
    by_name = {n: (r, s) for n, r, s in specs}
    assert by_name["w2v_a"][1] is True and by_name["relu0"][0] == []
    for ext, save in ((".h5", TCM.save_caffemodel_h5),
                      (".caffemodel", TCM.save_caffemodel_binaryproto)):
        path = str(tmp_path / f"gn{ext}")
        save(path, params, state, specs=specs)
        tp, ts = TQ.mms_qa_init(cfg, generator=torch.Generator(),
                                device="cpu")
        tp2, ts2, _ = TCM.load_caffemodel_auto(path, tp, ts)
        assert torch.equal(tp2["embed"]["w"], params["w2v_q"]["w"])
        assert torch.equal(tp2["conv0"]["w"], params["conv0"]["w"])
        assert torch.equal(tp2["fc1"]["w"], params["fc1"]["w"])
        assert torch.equal(ts2["bn0"]["mean"], state["bn0"]["mean"])


def test_family_detection_and_registration_match():
    rng = np.random.default_rng(5)
    jp, js = _v4_trees(rng)
    tp, ts = params_from_numpy(jp, js, "cpu")
    assert TCM.detect_family(tp) == JCM.detect_family(jp) == "mms_qa"
    with pytest.raises(ValueError, match="register one"):
        TCM.detect_family({"nothing": {}})

    def specs(params, state):
        return [("only", [(0, "params", ("only", "w"), lambda a: a,
                           lambda a: a)], False)]

    TCM.register_model_family("one_leaf", lambda p: "only" in p, specs)
    try:
        assert TCM.detect_family({"only": {"w": torch.ones(2)}}) == \
            "one_leaf"
    finally:
        TCM._FAMILIES.pop(0)


def test_shape_mismatch_and_truncation_refused(tmp_path):
    rng = np.random.default_rng(6)
    jp, js = _v4_trees(rng)
    path = str(tmp_path / "v4.caffemodel")
    JCM.save_caffemodel_binaryproto(path, jp, js)
    cfg = dataclasses.replace(TQ.V4, vocab_size=51)
    tp, ts = TQ.mms_qa_init(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        TCM.load_caffemodel_binaryproto(path, tp, ts)
    assert os.path.getsize(path) > 0
