"""The port's public op signatures take the JAX package's keywords with its
defaults and compute what it computes: one case per row of the table of
narrower signatures that ROADMAP.md's Queue 3 logged, on the same seeded
numpy inputs.  Tolerance: shapes exactly, values rtol 1e-5 (atol 1e-6):
float32 sums in another order.  ``QueryEngine(scan_chunks=)`` and
``QAServer(pad_buckets=)``: top-k as ``test_torch_engine_scale.py`` holds
it (scores within 1e-5 of the row's max, indices where the scores are
further apart), the servers' replies and padded row counts equal."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import ops as jops
from mms_answer_selection_tpu.ops import batch_norm as j_bn
from mms_answer_selection_tpu.serve import QAServer as JServer
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.utils import caffemodel as JCM
from mms_answer_selection_tpu_torch import ops as tops
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.ops import batch_norm as t_bn
from mms_answer_selection_tpu_torch.serve import QAServer, QueryEngine
from mms_answer_selection_tpu_torch.utils import caffemodel as TCM

TOL = dict(rtol=1e-5, atol=1e-6)
rng = np.random.default_rng(11)


def _np(shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _check(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# -- BN: bn_init(8); bn_init(8, shift_value=0., scale_value=2.); eps --------

@pytest.mark.parametrize("kw", [{}, {"shift_value": 0.0, "scale_value": 2.0},
                                {"scale_value": 0.5}])
def test_bn_init_defaults_and_scale(kw):
    tp, ts = tops.bn_init(8, **kw)
    jp, js = jops.bn_init(8, **kw)
    for k in ("scale", "shift"):
        _check(tp[k], jp[k])
    for k in ("mean", "var"):
        _check(ts[k], js[k])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-9])
def test_bn_apply_eps(train, eps):
    x = _np((4, 3, 5, 6))
    params = {"scale": _np((6,)), "shift": _np((6,))}
    state = {"mean": _np((6,)), "var": np.abs(_np((6,))) + 0.1}
    y, st = tops.bn_apply(_t(params), _t(state), torch.from_numpy(x),
                          train=train, eps=eps)
    jy, jst = jops.bn_apply(params, state, jnp.asarray(x), train=train,
                            eps=eps)
    _check(y, jy)
    for k in ("mean", "var"):
        _check(st[k], jst[k])


def test_default_momentum_name_and_alias():
    assert t_bn.DEFAULT_MOMENTUM == j_bn.DEFAULT_MOMENTUM == 0.9
    assert t_bn.MOMENTUM == t_bn.DEFAULT_MOMENTUM
    sig = inspect.signature(tops.bn_apply)
    assert sig.parameters["momentum"].default == t_bn.DEFAULT_MOMENTUM
    assert sig.parameters["eps"].default == \
        inspect.signature(jops.bn_apply).parameters["eps"].default


# -- conv2d(stride=, padding=) ------------------------------------------------

@pytest.mark.parametrize("kw,shape", [
    ({"stride": 2}, (2, 3, 3, 4)),
    ({"padding": "SAME"}, (2, 7, 7, 4)),
    ({"padding": "VALID"}, (2, 5, 5, 4)),
    ({"stride": 2, "padding": "SAME"}, (2, 4, 4, 4)),
    ({"padding": ((1, 0), (0, 2))}, (2, 6, 7, 4)),
])
def test_conv2d_stride_and_padding(kw, shape):
    x = _np((2, 7, 7, 3))
    params = {"w": _np((3, 3, 3, 4)), "b": _np((4,))}
    got = tops.conv2d(_t(params), torch.from_numpy(x), **kw)
    want = jops.conv2d({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), **kw)
    assert tuple(got.shape) == shape
    _check(got, want)


def test_conv2d_same_puts_the_odd_pad_at_the_end():
    # an even kernel pads (0, 1): XLA's rule, which the reference's
    # symmetric pad cannot express
    x = _np((1, 6, 5, 2))
    params = {"w": _np((2, 4, 2, 3)), "b": _np((3,))}
    got = tops.conv2d(_t(params), torch.from_numpy(x), padding="SAME")
    want = jops.conv2d({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), padding="SAME")
    _check(got, want)


# -- dropout(train=) ------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_dropout_off_returns_the_input(ratio):
    x = torch.from_numpy(_np((3, 4)))
    assert tops.dropout(torch.Generator().manual_seed(0), x, ratio,
                        train=False) is x
    jx = jnp.asarray(x.numpy())
    assert jops.dropout(None, jx, ratio, train=False) is jx


def test_dropout_requires_train_as_jax_does():
    with pytest.raises(TypeError):
        tops.dropout(torch.Generator(), torch.ones(3), 0.5)
    assert inspect.signature(tops.dropout).parameters["train"].kind \
        == inspect.Parameter.KEYWORD_ONLY


# -- sim_cross_cosine(eps=, keep_measure_axis=) / inv_euclidean ---------------

@pytest.mark.parametrize("kw", [{}, {"eps": 1e-8}, {"keep_measure_axis": False},
                                {"eps": 0.5, "keep_measure_axis": False}])
def test_sim_cross_cosine_keywords(kw):
    q, a = _np((2, 5, 4)), _np((2, 6, 4))
    got = tops.sim_cross_cosine(torch.from_numpy(q), torch.from_numpy(a),
                                **kw)
    want = jops.sim_cross_cosine(jnp.asarray(q), jnp.asarray(a), **kw)
    assert tuple(got.shape) == ((2, 5, 6) if kw.get("keep_measure_axis") is
                                False else (2, 5, 6, 1))
    _check(got, want)


@pytest.mark.parametrize("keep", [True, False])
def test_sim_cross_inv_euclidean_keep_measure_axis(keep):
    q, a = _np((2, 5, 4)), _np((2, 6, 4))
    got = tops.sim_cross_inv_euclidean(torch.from_numpy(q),
                                       torch.from_numpy(a),
                                       keep_measure_axis=keep)
    want = jops.sim_cross_inv_euclidean(jnp.asarray(q), jnp.asarray(a),
                                        keep_measure_axis=keep)
    _check(got, want)


# -- register_model_family(spec_builder=) ---------------------------------------

def test_register_model_family_takes_spec_builder():
    def specs(params, state):
        return [("only", [(0, "params", ("only", "w"), lambda a: a,
                           lambda a: a)], False)]

    for mod in (TCM, JCM):
        mod.register_model_family("one_leaf", lambda p: "only" in p,
                                  spec_builder=specs)
        try:
            assert mod.detect_family({"only": {"w": np.ones(2)}}) \
                == "one_leaf"
        finally:
            mod._FAMILIES.pop(0)
    assert list(inspect.signature(TCM.register_model_family).parameters) \
        == list(inspect.signature(JCM.register_model_family).parameters)


# -- every public op takes at least the JAX package's keywords -----------------

@pytest.mark.parametrize("name", ["bn_init", "bn_apply", "conv2d", "dropout",
                                  "sim_cross_cosine",
                                  "sim_cross_inv_euclidean"])
def test_keywords_cover_the_reference(name):
    def kw(fn):
        return {n: p.default for n, p in
                inspect.signature(fn).parameters.items()
                if p.kind == inspect.Parameter.KEYWORD_ONLY}
    jkw, tkw = kw(getattr(jops, name)), kw(getattr(tops, name))
    # the JAX package's dtype / precision knobs have no torch counterpart
    # here: operands carry their dtype, and float32 runs at full precision
    jkw = {k: v for k, v in jkw.items()
           if k not in ("dtype", "preferred_dtype", "precision")}
    assert set(jkw) <= set(tkw)
    for k, v in jkw.items():
        assert tkw[k] == v, k


# -- QueryEngine(scan_chunks=True), QAServer(pad_buckets=True) -----------------

@pytest.mark.parametrize("cls,jcls,name", [
    (QueryEngine, JEngine, "scan_chunks"), (QAServer, JServer, "pad_buckets")])
def test_dispatch_keywords_and_defaults_are_jax(cls, jcls, name):
    tp = inspect.signature(cls.__init__).parameters[name]
    jp = inspect.signature(jcls.__init__).parameters[name]
    assert tp.default is jp.default is True
    assert tp.kind == jp.kind == inspect.Parameter.KEYWORD_ONLY


def _serving_pair(scan=True):
    from tests.test_torch_engine_scale import (
        CAND_IDS, CHUNK, JCFG, STATE_NP, PARAMS_NP, TCFG)
    import jax.numpy as jnp

    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=jnp.bfloat16, interpret=True,
                   chunk_size=CHUNK, scan_chunks=scan).build_index(CAND_IDS)
    params, state = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    teng = QueryEngine(params, TCFG, chunk_size=CHUNK, scan_chunks=scan,
                       device="cpu").build_index(CAND_IDS)
    return jeng, teng, state


@pytest.mark.parametrize("scan", [True, False])
def test_query_engine_scan_chunks_matches_jax(scan):
    from tests.test_torch_engine_scale import QUERY_IDS, _assert_topk_agrees

    jeng, teng, _ = _serving_pair(scan)
    _assert_topk_agrees(*teng.query(QUERY_IDS, k=10),
                        *jeng.query(QUERY_IDS, k=10))
    assert len(teng._calls.keys()) == int(scan)   # a graph key, or eager


@pytest.mark.parametrize("pad", [True, False])
def test_qaserver_pad_buckets_matches_jax(pad):
    from tests.test_torch_engine_scale import QUERY_IDS, STATE_NP

    jeng, teng, state = _serving_pair()
    jsrv = JServer(jeng, state=STATE_NP, pad_buckets=pad)
    tsrv = QAServer(teng, state=state, pad_buckets=pad)
    try:
        for req in ({"tokens": QUERY_IDS[:3].tolist(), "k": 5},
                    {"tokens": QUERY_IDS[:3].tolist(), "k": 2, "rerank": 8}):
            t, j = tsrv.handle_query(req), jsrv.handle_query(req)
            assert [[i for i, _ in r["topk"]] for r in t["results"]] == \
                [[i for i, _ in r["topk"]] for r in j["results"]]
            np.testing.assert_allclose(
                [[v for _, v in r["topk"]] for r in t["results"]],
                [[v for _, v in r["topk"]] for r in j["results"]], **TOL)
        assert tsrv.stats.snapshot()["device_dispatch_rows"] == \
            jsrv.stats.snapshot()["device_dispatch_rows"] == (8 if pad else 6)
    finally:
        tsrv.close()
        jsrv.close()
