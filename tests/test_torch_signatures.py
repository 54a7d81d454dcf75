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
                                  "sim_cross_inv_euclidean", "conv_init",
                                  "embed_init"])
def test_keywords_cover_the_reference(name):
    def kw(fn):
        return {n: p.default for n, p in
                inspect.signature(fn).parameters.items()
                if p.kind == inspect.Parameter.KEYWORD_ONLY}
    jkw, tkw = kw(getattr(jops, name)), kw(getattr(tops, name))
    # an op's dtype / precision knobs have no torch counterpart here:
    # operands carry their dtype, and float32 runs at full precision; an
    # init takes dtype, whose default is float32 in both packages
    skip = ("preferred_dtype", "precision") + (
        () if name.endswith("_init") else ("dtype",))
    jkw = {k: v for k, v in jkw.items() if k not in skip}
    assert set(jkw) <= set(tkw)
    for k, v in jkw.items():
        if k == "dtype":
            assert str(tkw[k]) == f"torch.{jnp.dtype(v).name}", k
        else:
            assert tkw[k] == v, k


# -- conv_init(bias_value=) fills the bias as JAX does --------------------------

@pytest.mark.parametrize("kw", [{}, {"bias_value": 0.1}])
def test_conv_init_bias_value(kw):
    import jax

    tp = tops.conv_init(torch.Generator().manual_seed(0), 3, 4, 3, 3, **kw)
    jp = jops.conv_init(jax.random.PRNGKey(0), 3, 4, 3, 3, **kw)
    _check(tp["b"], jp["b"])
    assert tuple(tp["w"].shape) == jp["w"].shape
    if kw:
        np.testing.assert_array_equal(tp["b"].numpy(),
                                      np.full(4, 0.1, np.float32))


# -- dtype= on every init: each leaf's dtype and shape are JAX's ---------------
# (the values are not compared: a torch.Generator is not a jax.random key)

GRAPH_INIT_NET = """
layer { name: "d" type: "Input" top: "x" top: "ids" }
layer { name: "em" type: "Embed" bottom: "ids" top: "em"
  embed_param { input_dim: 20 num_output: 6
    weight_filler { type: "uniform" min: -0.1 max: 0.1 } } }
layer { name: "cv" type: "Convolution" bottom: "x" top: "cv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "msra" } bias_filler { type: "constant"
    value: 0.5 } } }
layer { name: "dc" type: "Deconvolution" bottom: "cv" top: "dc"
  convolution_param { num_output: 4 kernel_size: 4 stride: 2 group: 4
    weight_filler { type: "bilinear" } bias_term: false } }
layer { name: "bn" type: "BatchNorm" bottom: "cv" top: "bn" }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
  scale_param { bias_term: true } }
layer { name: "pr" type: "PReLU" bottom: "sc" top: "pr"
  prelu_param { filler { type: "positive_unitball" } } }
layer { name: "ip" type: "InnerProduct" bottom: "pr" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian"
    std: 0.1 } bias_filler { type: "xavier" } } }
"""


def _leaf_types(tree):
    """{path: (dtype name, shape)} of a tree of arrays or tensors."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            name = str(node.dtype).replace("torch.", "")
            out[path] = (name, tuple(node.shape))

    walk(tree, ())
    return out


def _init_pair(name, jdt, tdt):
    """(JAX tree, port tree) of the init ``name`` at one dtype."""
    import jax

    from mms_answer_selection_tpu.models import caption_image as JC
    from mms_answer_selection_tpu.models import graph_net as JG
    from mms_answer_selection_tpu.models import mms_qa as JQ
    from mms_answer_selection_tpu.models import pair_image as JP
    from mms_answer_selection_tpu.ops import recurrent as JR
    from mms_answer_selection_tpu.utils import fillers as JF
    from mms_answer_selection_tpu_torch.models import caption_image as TC
    from mms_answer_selection_tpu_torch.models import graph_net as TG
    from mms_answer_selection_tpu_torch.models import mms_qa as TQ
    from mms_answer_selection_tpu_torch.models import pair_image as TP
    from mms_answer_selection_tpu_torch.ops import recurrent as TR
    from mms_answer_selection_tpu_torch.utils import fillers as TF

    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)

    def cfgs(jcls, tcls, **kw):
        j = jcls(**kw)
        t = tcls(**{**kw, "blocks": tuple(tcls().blocks[0].__class__(
            **{f: getattr(b, f) for f in b.__dataclass_fields__})
            for b in j.blocks)})
        return j, t

    if name == "mms_qa_init":
        j, t = cfgs(JQ.MMSQAConfig, TQ.MMSQAConfig, vocab_size=30,
                    embed_dim=8, question_len=8, answer_len=8,
                    sim_measures=2, sim_weight_init="xavier", sim_bias=True,
                    blocks=(JQ.ConvBlock(3, 3, 4, "max", 2, 2),),
                    fc1_dim=4)
        return (JQ.mms_qa_init(key, j, dtype=jdt),
                TQ.mms_qa_init(t, generator=gen, dtype=tdt))
    if name == "caption_image_init":
        j, t = cfgs(JC.CaptionImageConfig, TC.CaptionImageConfig)
        return (JC.caption_image_init(key, j, dtype=jdt),
                TC.caption_image_init(t, generator=gen, dtype=tdt))
    if name == "pair_image_init":
        j, t = cfgs(JP.PairImageConfig, TP.PairImageConfig)
        return (JP.pair_image_init(key, j, dtype=jdt),
                TP.pair_image_init(t, generator=gen, dtype=tdt))
    if name == "conv_init":
        return (jops.conv_init(key, 3, 4, 3, 3, dtype=jdt),
                tops.conv_init(gen, 3, 4, 3, 3, dtype=tdt))
    if name == "embed_init":
        vecs = _np((5, 6))
        return (jops.embed_init(key, 20, 6, pretrained=vecs, dtype=jdt),
                tops.embed_init(gen, 20, 6, pretrained=vecs, dtype=tdt))
    if name == "bn_init":
        return jops.bn_init(4, dtype=jdt), tops.bn_init(4, dtype=tdt)
    if name in ("lstm_init", "rnn_init"):
        return (getattr(JR, name)(key, 5, 3, dtype=jdt),
                getattr(TR, name)(gen, 5, 3, dtype=tdt))
    if name == "GraphNet.init":
        # the walk runs the layers: the input takes the weights' dtype
        x = np.zeros((2, 3, 6, 6), np.float32)
        ids = np.zeros((2, 4), np.int32)
        jp = JG.GraphNet(GRAPH_INIT_NET).init(
            key, {"x": jnp.asarray(x, jdt), "ids": jnp.asarray(ids)},
            dtype=jdt)
        tp = TG.GraphNet(GRAPH_INIT_NET).init(
            gen, {"x": torch.from_numpy(x).to(tdt),
                  "ids": torch.from_numpy(ids)}, dtype=tdt, device="cpu")
        return jp, tp
    shape = (4, 3, 2, 2)
    return ({f: getattr(JF, f)(*([] if f == "bilinear" else [key]), shape,
                               **({"dtype": jdt}))
             for f in ("xavier", "gaussian", "msra", "positive_unitball",
                       "bilinear")}
            | {"uniform": JF.uniform(key, shape, -1.0, 1.0, dtype=jdt),
               "constant": JF.constant(shape, 0.5, dtype=jdt)},
            {f: getattr(TF, f)(*([] if f == "bilinear" else [gen]), shape,
                               dtype=tdt)
             for f in ("xavier", "gaussian", "msra", "positive_unitball",
                       "bilinear")}
            | {"uniform": TF.uniform(gen, shape, -1.0, 1.0, dtype=tdt),
               "constant": TF.constant(shape, 0.5, dtype=tdt)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [
    "mms_qa_init", "caption_image_init", "pair_image_init", "conv_init",
    "embed_init", "bn_init", "lstm_init", "rnn_init", "GraphNet.init",
    "fillers"])
def test_inits_take_dtype_as_jax_does(name, dtype):
    jtree, ttree = _init_pair(name, getattr(jnp, dtype),
                              getattr(torch, dtype))
    want = _leaf_types(jtree)
    assert want and _leaf_types(ttree) == want
    assert {d for d, _ in want.values()} == {dtype}


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


# -- departures logged in ROADMAP.md Queue 3 -----------------------------------

def test_scan_train_steps_takes_no_root_key():
    """JAX's ``scan_train_steps`` takes the root PRNG key ``fit`` uses; the
    port's draws its dropout seeds from ``TrainerConfig.seed`` as ``fit``
    does, so it takes none, and two trainers of one seed give the same
    chunk."""
    from mms_answer_selection_tpu.training import Trainer as JTrainer
    from mms_answer_selection_tpu_torch.models import mms_qa as TQ
    from mms_answer_selection_tpu_torch.training import (Trainer,
                                                         TrainerConfig)

    jp = list(inspect.signature(JTrainer.scan_train_steps).parameters)
    tp = list(inspect.signature(Trainer.scan_train_steps).parameters)
    assert jp == tp + ["root_key"]
    cfg = TQ.MMSQAConfig(vocab_size=30, embed_dim=8, question_len=8,
                         answer_len=8, sim_measures=2, sim_dropout=0.5,
                         sim_weight_init="xavier",
                         blocks=(TQ.ConvBlock(3, 3, 4, "max", 2, 2),),
                         fc1_dim=4)
    g = torch.Generator().manual_seed(1)
    batches = {"question": torch.randint(0, 30, (2, 4, 8), generator=g),
               "answer": torch.randint(0, 30, (2, 4, 8), generator=g),
               "overlap_feat": torch.rand((2, 4, 2), generator=g),
               "label": torch.randint(0, 2, (2, 4), generator=g)}
    losses = []
    for seed in (5, 5, 6):
        tr = Trainer(cfg, TrainerConfig(seed=seed, batch_size=4),
                     device="cpu")
        losses.append(tr.scan_train_steps(*tr.init(), batches, 0)[3])
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[0], losses[2])


def test_batch_iterator_takes_device_for_device_put():
    """JAX's ``BatchIterator(device_put=True)`` moves each batch to the
    default device; the port names the device (``device=``), and
    ``None`` keeps numpy batches as ``device_put=False`` does."""
    from mms_answer_selection_tpu.data import loader as JL
    from mms_answer_selection_tpu_torch.data import loader as TL

    jp = inspect.signature(JL.BatchIterator.__init__).parameters
    tp = inspect.signature(TL.BatchIterator.__init__).parameters
    assert set(jp) - set(tp) == {"device_put"}
    assert set(tp) - set(jp) == {"device"}
    assert jp["device_put"].default is False and tp["device"].default is None
    data = {"x": np.arange(12, dtype=np.float32).reshape(6, 2)}
    j = next(JL.BatchIterator(JL.ArrayDataset(data), 3, shuffle=False))
    t = next(TL.BatchIterator(TL.ArrayDataset(data), 3, shuffle=False))
    on_cpu = next(TL.BatchIterator(TL.ArrayDataset(data), 3, shuffle=False,
                                   device="cpu"))
    assert isinstance(t["x"], np.ndarray)
    np.testing.assert_array_equal(t["x"], np.asarray(j["x"]))
    assert torch.is_tensor(on_cpu["x"]) and on_cpu["x"].device.type == "cpu"
    np.testing.assert_array_equal(on_cpu["x"].numpy(), t["x"])
