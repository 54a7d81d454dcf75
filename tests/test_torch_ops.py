"""Parity of the PyTorch port's ops with the JAX package's, on the same
seeded numpy inputs.  Tolerance: float32, atol = rtol = 1e-5 (JAX runs its
products at HIGHEST precision; only summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu import ops as jops
from mms_answer_selection_tpu.ops.pooling import (
    avg_pool2d as j_avg_pool2d,
    max_pool2d as j_max_pool2d,
)
from mms_answer_selection_tpu_torch import ops as tops
from mms_answer_selection_tpu_torch.utils import fillers

TOL = dict(rtol=1e-5, atol=1e-5)
rng = np.random.default_rng(2024)


def _np(x):
    return rng.normal(size=x).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def test_embed_lookup_clamps_and_adds_bias():
    params = {"w": _np((11, 6)), "b": _np((6,))}
    ids = np.array([[-3, 0, 5], [10, 11, 100]], np.int32)
    got = tops.embed_lookup({k: torch.from_numpy(v) for k, v in params.items()},
                            torch.from_numpy(ids))
    want = jops.embed_lookup({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(ids))
    _close(got, want)
    assert got.shape == (2, 3, 6)


# ids of (4, 10) lookups into a table of 13 rows: some rows repeated;
# ids below 0 and at or past V, which clamp onto rows 0 and 12; the
# recipe's padding, where most ids are the last row
EMBED_GRAD_IDS = {
    "repeated": np.array([[3, 1, 3, 7, 3, 1, 0, 3, 5, 3]] * 4, np.int32),
    "clamped": np.array([[-5, -1, 0, 12, 13, 40, 6, -2, 12, 99]] * 4,
                        np.int32),
    "pad_heavy": np.concatenate(
        [np.random.default_rng(7).integers(0, 12, (4, 4)),
         np.full((4, 6), 12)], 1
    ).astype(np.int32),
}


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("ids", sorted(EMBED_GRAD_IDS))
def test_embed_lookup_gradient_is_jaxs(ids, with_bias):
    """The table's (and the bias') gradient of a lookup, each id's rows
    of the cotangent summed, against ``jax.grad`` of the JAX lookup."""
    ids = EMBED_GRAD_IDS[ids]
    draw = np.random.default_rng(8)
    normal = lambda *s: draw.normal(size=s).astype(np.float32)  # noqa: E731
    params = {"w": normal(13, 6)}
    if with_bias:
        params["b"] = normal(6)
    cot = normal(*ids.shape, 6)
    tparams = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in params.items()}
    (tops.embed_lookup(tparams, torch.from_numpy(ids))
     * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda p: (jops.embed_lookup(p, jnp.asarray(ids))
                               * cot).sum())(
        {k: jnp.asarray(v) for k, v in params.items()})
    assert sorted(want) == sorted(tparams)
    for k in want:
        _close(tparams[k].grad, want[k])


def test_embed_grad_kernel_refuses_cpu_tensors():
    # the CPU lookup takes the autograd of w[ids]; the kernel's wrapper
    # never hands a host pointer to the card
    from mms_answer_selection_tpu_torch.ops.embed import embed_grad

    with pytest.raises(ValueError):
        embed_grad(torch.zeros(4, dtype=torch.int64), torch.zeros(4, 3), 5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_sim_cross_bilinear(with_bias):
    q, a, w = _np((3, 5, 6)), _np((3, 7, 6)), _np((4, 6, 6))
    b = _np((4, 5, 7)) if with_bias else None
    got = tops.sim_cross_bilinear(
        torch.from_numpy(q), torch.from_numpy(a), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b))
    want = jops.sim_cross_bilinear(q, a, w, b)
    assert got.shape == (3, 5, 7, 4)
    _close(got, want)


@pytest.mark.parametrize("name", ["sim_cross_cosine",
                                  "sim_cross_inv_euclidean"])
def test_sim_cross_unlearned(name):
    q, a = _np((2, 5, 6)), _np((2, 4, 6))
    got = getattr(tops, name)(torch.from_numpy(q), torch.from_numpy(a))
    want = getattr(jops, name)(jnp.asarray(q), jnp.asarray(a))
    assert got.shape == (2, 5, 4, 1)
    _close(got, want)


def test_conv2d_nhwc_hwio_valid():
    x = _np((2, 9, 8, 3))
    params = {"w": _np((3, 2, 3, 5)), "b": _np((5,))}
    got = tops.conv2d({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x))
    want = jops.conv2d({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x))
    assert got.shape == (2, 7, 7, 5)
    _close(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_bn_apply(train):
    x = _np((4, 5, 6, 3)) * 2.0 + 0.5
    params = {"scale": _np((3,)), "shift": _np((3,))}
    state = {"mean": _np((3,)), "var": np.abs(_np((3,))) + 0.1}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    y, st = tops.bn_apply(t(params), t(state), torch.from_numpy(x),
                          train=train)
    jy, jst = jops.bn_apply(params, state, jnp.asarray(x), train=train)
    _close(y, jy)
    for k in ("mean", "var"):
        _close(st[k], jst[k])


def test_bn_eps_is_on_the_variance():
    # a constant channel has zero batch variance: y = shift exactly, and the
    # 1e-9 eps keeps it finite (nn.BatchNorm2d's 1e-5 would differ)
    x = np.ones((2, 3, 3, 1), np.float32)
    p = {"scale": torch.ones(1), "shift": torch.full((1,), 1e-3)}
    s = {"mean": torch.zeros(1), "var": torch.zeros(1)}
    y, st = tops.bn_apply(p, s, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.numpy(), 1e-3, atol=1e-7)
    np.testing.assert_allclose(st["mean"].numpy(), 0.1, rtol=1e-6)


# (H, W, k, stride): ragged shapes whose last window is clipped, a stride
# larger than the kernel, and the V4 recipe's exact-fit pools
POOL_CASES = [(11, 9, 4, 3), (7, 7, 2, 3), (36, 36, 4, 4), (6, 6, 5, 1),
              (10, 13, 3, 2), (5, 5, 6, 6)]


@pytest.mark.parametrize("h,w,k,s", POOL_CASES)
@pytest.mark.parametrize("kind", ["max", "ave"])
def test_pooling_caffe_ceil_mode(kind, h, w, k, s):
    x = _np((2, h, w, 3))
    tfn, jfn = ((tops.max_pool2d, j_max_pool2d) if kind == "max"
                else (tops.avg_pool2d, j_avg_pool2d))
    got = tfn(torch.from_numpy(x), k, k, stride_h=s, stride_w=s)
    want = jfn(jnp.asarray(x), k, k, stride_h=s, stride_w=s)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_dropout_scales_kept_units():
    x = torch.ones(4000)
    y = tops.dropout(torch.Generator().manual_seed(0), x, 0.25, train=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.75, rtol=1e-6)


def test_dropout_is_reproducible_from_the_generator():
    x = torch.ones(64)
    a = tops.dropout(torch.Generator().manual_seed(3), x, 0.5, train=True)
    b = tops.dropout(torch.Generator().manual_seed(3), x, 0.5, train=True)
    assert torch.equal(a, b)


def test_softmax_cross_entropy_and_its_cap():
    logits = _np((6, 2)) * 3.0
    logits[0] = [200.0, -200.0]     # label 1 underflows: the capped case
    labels = np.array([1, 0, 1, 1, 0, 0], np.int32)
    tl = torch.from_numpy(logits).requires_grad_(True)
    loss = tops.softmax_cross_entropy(tl, torch.from_numpy(labels))
    jloss = jops.softmax_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels))
    _close(loss, jloss)
    # the cap is straight-through: the gradient is still prob - onehot
    loss.backward()
    jgrad = jax.grad(lambda z: jops.softmax_cross_entropy(
        z, jnp.asarray(labels)))(jnp.asarray(logits))
    _close(tl.grad, jgrad)


def test_fillers_ranges_and_generator():
    g = torch.Generator().manual_seed(1)
    u = fillers.uniform(g, (1000,), -0.08, 0.08)
    assert float(u.min()) >= -0.08 and float(u.max()) <= 0.08
    x = fillers.xavier(torch.Generator().manual_seed(1), (12, 3))
    s = (3.0 / 3) ** 0.5
    assert float(x.abs().max()) <= s
    assert torch.equal(x, fillers.xavier(torch.Generator().manual_seed(1),
                                         (12, 3)))


@pytest.mark.parametrize("bias_term", [True, False])
def test_embed_init_pretrained_rows(bias_term):
    pre = _np((4, 6))
    got = tops.embed_init(torch.Generator().manual_seed(0), 9, 6,
                          pretrained=pre, bias_term=bias_term)
    want = jops.embed_init(jax.random.PRNGKey(0), 9, 6, pretrained=pre,
                           bias_term=bias_term)
    assert sorted(got) == sorted(want)
    # the pretrained rows are written as given, the rest stay uniform
    np.testing.assert_array_equal(got["w"][:4].numpy(),
                                  np.asarray(want["w"][:4]))
    assert float(got["w"][4:].abs().max()) <= 0.08
    if bias_term:
        assert torch.equal(got["b"], torch.zeros(6))


@pytest.mark.parametrize("shape", [(3, 5), (10, 6)])
def test_embed_init_refuses_what_jax_refuses(shape):
    pre = _np(shape)          # wrong width; more rows than the vocab
    with pytest.raises(ValueError):
        jops.embed_init(jax.random.PRNGKey(0), 9, 6, pretrained=pre)
    with pytest.raises(ValueError):
        tops.embed_init(torch.Generator(), 9, 6, pretrained=pre)


# bf16 compute: the sim map and the first conv's weights rounded to bf16,
# their products summed in float32.  The port and JAX then agree on the
# logits to within 9e-8 at these widths, where bf16 moves them from float32
# by 5e-7 to 9e-6: the port is held to JAX at BF16_TOL, and the bf16 effect
# must be BF16_RATIO times that gap, so a cast placed elsewhere, or none,
# fails
BF16_TOL = 3e-7
BF16_RATIO = 5


def _bf16_check(JQ, TQ, jcfg, tcfg, jp, js, tp, ts, batch, tb):
    """The port's bf16 forward against JAX's (the first conv's weights given
    to JAX in bf16, as its conv takes one dtype for both operands), and the
    bf16 effect against the port's gap to JAX."""
    jp16 = dict(jp, conv0=jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16), jp["conv0"]))
    jb = jax.tree.map(jnp.asarray, batch)
    want, _ = JQ.mms_qa_apply(jp16, js, jb, jcfg, train=False,
                              compute_dtype=jnp.bfloat16)
    got, _ = TQ.mms_qa_apply(tp, ts, tb, tcfg, train=False,
                             compute_dtype=torch.bfloat16)
    f32, _ = TQ.mms_qa_apply(tp, ts, tb, tcfg, train=False)
    assert got["logits"].dtype == got["prob"].dtype == torch.float32
    for k in ("logits", "prob"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=BF16_TOL)
    gap = float(np.abs(got["logits"].numpy()
                       - np.asarray(want["logits"])).max())
    moved = float((got["logits"] - f32["logits"]).abs().max())
    assert moved >= BF16_RATIO * max(gap, 1e-9), (gap, moved)


def _bf16_case(blocks):
    import dataclasses

    from mms_answer_selection_tpu.models import mms_qa as JQ
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.models import mms_qa as TQ

    jcfg = JQ.MMSQAConfig(vocab_size=200, embed_dim=8, question_len=12,
                          answer_len=12, sim_measures=2,
                          sim_weight_init="xavier", blocks=blocks, fc1_dim=4)
    tcfg = TQ.MMSQAConfig(**{**dataclasses.asdict(jcfg), "blocks": tuple(
        TQ.ConvBlock(**dataclasses.asdict(b)) for b in jcfg.blocks)})
    jp, js = JQ.mms_qa_init(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    js = {k: {"mean": _np(v["mean"].shape) * 0.1,
              "var": np.abs(_np(v["var"].shape)) + 0.5}
          for k, v in js.items()}
    batch = {"question": rng.integers(0, 200, (8, 12)).astype(np.int32),
             "answer": rng.integers(0, 200, (8, 12)).astype(np.int32),
             "overlap_feat": rng.random((8, 2)).astype(np.float32)}
    tp, ts = params_from_numpy(jp, js, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return JQ, TQ, jcfg, tcfg, jp, js, tp, ts, batch, tb


def test_compute_dtype_bf16_matches_jax():
    """JAX casts the sim map and runs the conv on it; its conv takes one
    dtype for both operands and accumulates to float32, so its one block's
    weights are given in bf16 there.  The port casts the block's weights
    itself."""
    from mms_answer_selection_tpu.models.mms_qa import ConvBlock
    _bf16_check(*_bf16_case((ConvBlock(3, 3, 4, "ave", 2, 2),)))


def test_compute_dtype_bf16_two_blocks_against_float32():
    """Two blocks: the second conv takes the first block's float32 output,
    in float32, as JAX's does; the BN state stays float32; ``None`` is the
    float32 forward."""
    from mms_answer_selection_tpu.models.mms_qa import ConvBlock
    case = _bf16_case((ConvBlock(3, 3, 4, "ave", 2, 2),
                       ConvBlock(3, 3, 4, "ave", 3, 1)))
    _bf16_check(*case)
    JQ, TQ, jcfg, tcfg, jp, js, tp, ts, batch, tb = case
    want, _ = JQ.mms_qa_apply(jp, js, jax.tree.map(jnp.asarray, batch), jcfg,
                              train=False)
    _, st = TQ.mms_qa_apply(tp, ts, dict(tb, label=torch.zeros(
        8, dtype=torch.int64)), tcfg, train=True,
        generator=torch.Generator().manual_seed(0),
        compute_dtype=torch.bfloat16)
    assert all(v.dtype == torch.float32 for s in st.values()
               for v in s.values())
    none, _ = TQ.mms_qa_apply(tp, ts, tb, tcfg, train=False,
                              compute_dtype=None)
    np.testing.assert_allclose(none["prob"].numpy(),
                               np.asarray(want["prob"]), **TOL)
