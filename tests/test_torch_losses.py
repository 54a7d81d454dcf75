"""The reference's remaining loss and similarity layers and the fillers:
the port against the JAX package on the same seeded numpy inputs.

Losses, ``sim_matrix`` and ``fm_pool``: values and gradients (autograd
against ``jax.grad``) within 1e-6 of the array's largest |value| (the
relative measure the card's kernel checks use): float32 on both sides,
only the order of a few short sums differs, which moves a single element
by up to ~2e-6 of itself where its terms cancel.  The
kinks are exact inputs (a hinge argument of exactly 0, a = b under |.|),
where both packages give max(0, z) the gradient 1/2 and |x| the gradient
0.  Fillers: the deterministic ones (constant, bilinear) exactly; the
random ones by shape, bounds and moments (the draws differ from
``jax.random`` by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.ops import losses as jl
from mms_answer_selection_tpu.ops import similarity as jsim
from mms_answer_selection_tpu.utils import fillers as jf
from mms_answer_selection_tpu_torch import ops as tops
from mms_answer_selection_tpu_torch.utils import fillers as tf

RTOL = 1e-6


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (err, scale)
rng = np.random.default_rng(808)


def _np(*shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _both(j_fn, t_fn, floats, ints=(), **kw):
    """Value and gradients w.r.t. every array of ``floats`` from both
    packages, held to TOL."""
    def jf_(*xs):
        return j_fn(*xs, *(jnp.asarray(i) for i in ints), **kw)

    jv, jg = jax.value_and_grad(jf_, argnums=tuple(range(len(floats))))(
        *(jnp.asarray(x) for x in floats))
    ts = [torch.tensor(x, requires_grad=True) for x in floats]
    tv = t_fn(*ts, *(torch.as_tensor(i) for i in ints), **kw)
    tg = torch.autograd.grad(tv, ts)
    _close(float(tv.detach()), float(jv))
    for t, j in zip(tg, jg):
        _close(t.numpy(), np.asarray(j))
    return tv, tg


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("margin", [1.0, 0.5])
def test_pair_rank_loss_random(margin):
    a, b = _np(16), _np(16)
    label = (rng.random(16) < 0.5).astype(np.float32)
    _both(jl.pair_rank_loss, tops.pair_rank_loss, (a, b, label),
          margin=margin)


def test_pair_rank_loss_at_its_kinks():
    # label 1 with a - b = margin (the hinge at exactly 0: gradient 1/2);
    # label 0 with a = b (|x| at 0: jnp.abs's gradient there is +1, where
    # torch.abs's would be 0); label 1 with a = b (inside the hinge);
    # label 0 with a != b; label -1 past the margin
    a = np.array([1.5, 0.25, 0.25, 2.0, -1.0], np.float32)
    b = np.array([0.5, 0.25, 0.25, 1.0, 1.0], np.float32)
    label = np.array([1.0, 0.0, 1.0, 0.0, -1.0], np.float32)
    _, (ga, gb, _) = _both(jl.pair_rank_loss, tops.pair_rank_loss,
                           (a, b, label))
    np.testing.assert_array_equal(ga.numpy(), np.array(
        [-0.5, 1.0, -1.0, 1.0, -2.0], np.float32) / 5)
    np.testing.assert_array_equal(gb.numpy(), -ga.numpy())


@pytest.mark.parametrize("kink", [False, True])
def test_sigmoid_cross_entropy(kink):
    logits = _np(6, 5)
    if kink:
        logits[:, :2] = 0.0          # max(x, 0) and |x| at their kinks
    targets = rng.random((6, 5)).astype(np.float32)
    _both(jl.sigmoid_cross_entropy, tops.sigmoid_cross_entropy,
          (logits, targets))


def test_euclidean_loss():
    _both(jl.euclidean_loss, tops.euclidean_loss, (_np(7, 4), _np(7, 4)))


@pytest.mark.parametrize("norm", ["L1", "L2"])
@pytest.mark.parametrize("kink", [False, True])
def test_hinge_loss(norm, kink):
    scores = _np(8, 4)
    labels = rng.integers(0, 4, 8).astype(np.int32)
    if kink:                          # 1 + sign * s = 0 exactly
        scores[0, labels[0]] = 1.0
        scores[1, (labels[1] + 1) % 4] = -1.0
    _both(jl.hinge_loss, tops.hinge_loss, (scores,), (labels,), norm=norm)


def test_multinomial_logistic_loss_and_its_clamp():
    probs = rng.random((6, 3)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    probs[0, labels[0]] = 1e-30       # under the 1e-20 clamp
    _both(jl.multinomial_logistic_loss, tops.multinomial_logistic_loss,
          (probs,), (labels,))


def test_infogain_loss_and_its_identity_case():
    probs = rng.random((6, 3)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    h = rng.random((3, 3)).astype(np.float32)
    _both(lambda p, h, y: jl.infogain_loss(p, y, h),
          lambda p, h, y: tops.infogain_loss(p, y, h), (probs, h), (labels,))
    t = torch.as_tensor
    _close(float(tops.infogain_loss(t(probs), t(labels), torch.eye(3))),
           float(tops.multinomial_logistic_loss(t(probs), t(labels))))


@pytest.mark.parametrize("legacy", [False, True])
def test_contrastive_loss(legacy):
    a, b = _np(8, 3), _np(8, 3)
    y = (rng.random(8) < 0.5).astype(np.float32)
    # kinks: d = margin (non-legacy) / d^2 = margin (legacy) on a
    # dissimilar pair, and a = b on a similar one
    a[0], b[0], y[0] = [1.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0
    a[1], b[1], y[1] = [0.5, 0.5, 0.5], [0.5, 0.5, 0.5], 1.0
    _both(jl.contrastive_loss, tops.contrastive_loss, (a, b, y),
          margin=1.0, legacy=legacy)


@pytest.mark.parametrize("ignore", [None, 2, -1])
def test_softmax_cross_entropy_ignore_label(ignore):
    logits = _np(10, 3, scale=3.0)
    labels = rng.integers(0, 3, 10).astype(np.int32)
    labels[:3] = -1 if ignore == -1 else 2
    _both(jl.softmax_cross_entropy, tops.softmax_cross_entropy, (logits,),
          (labels,), ignore_label=ignore)


def test_softmax_cross_entropy_all_ignored_is_zero():
    logits = torch.tensor(_np(4, 3), requires_grad=True)
    loss = tops.softmax_cross_entropy(logits, torch.full((4,), 1),
                                      ignore_label=1)
    assert float(loss.detach()) == 0.0
    assert float(torch.autograd.grad(loss, logits)[0].abs().max()) == 0.0


# -------------------------------------------------------------- similarity
def test_sim_matrix():
    _both(lambda x, y, w: jnp.sum(jsim.sim_matrix(x, y, w) * 1.5),
          lambda x, y, w: torch.sum(tops.sim_matrix(x, y, w) * 1.5),
          (_np(5, 4), _np(5, 6), _np(4, 6)))
    assert tops.sim_matrix(torch.ones(5, 4), torch.ones(5, 6),
                           torch.ones(4, 6)).shape == (5, 1)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fm_pool(with_bias):
    x, bias = _np(3, 4, 5), _np(1)
    weights = _np(3, 1)

    def j_fn(x, bias):
        return jnp.sum(jsim.fm_pool(x, bias if with_bias else None) * weights)

    def t_fn(x, bias):
        out = tops.fm_pool(x, bias if with_bias else None)
        return torch.sum(out * torch.as_tensor(weights)) + 0.0 * bias.sum()

    if with_bias:
        _both(j_fn, t_fn, (x, bias))
    else:
        _both(lambda x: j_fn(x, None), lambda x: t_fn(x, torch.zeros(1)),
              (x,))


# ----------------------------------------------------------------- fillers
def test_constant_and_bilinear_equal_jax():
    np.testing.assert_array_equal(tf.constant((2, 3), 0.25).numpy(),
                                  np.asarray(jf.constant((2, 3), 0.25)))
    for shape in [(3, 2, 4, 4), (1, 1, 3, 5), (2, 7, 6)]:
        np.testing.assert_allclose(tf.bilinear(shape).numpy(),
                                   np.asarray(jf.bilinear(shape)), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["gaussian", "msra"])
def test_normal_fillers_moments(name):
    g = torch.Generator().manual_seed(3)
    shape = (64, 32, 3, 3)
    if name == "gaussian":
        x = tf.gaussian(g, shape, mean=0.5, std=2.0)
        mean, std = 0.5, 2.0
    else:
        x = tf.msra(g, shape)
        mean, std = 0.0, (2.0 / (32 * 9)) ** 0.5
        np.testing.assert_allclose(float(tf.msra(g, shape, fan_in=50).std()),
                                   (2.0 / 50) ** 0.5, rtol=0.02)
    assert x.shape == shape and x.dtype == torch.float32
    # 18,432 draws: the mean within 4 standard errors, the std within 2%
    assert abs(float(x.mean()) - mean) < 4 * std / x.numel() ** 0.5
    np.testing.assert_allclose(float(x.std()), std, rtol=0.02)
    again = (tf.gaussian(torch.Generator().manual_seed(3), shape, 0.5, 2.0)
             if name == "gaussian"
             else tf.msra(torch.Generator().manual_seed(3), shape))
    assert torch.equal(x, again)


def test_positive_unitball_rows_sum_to_one():
    x = tf.positive_unitball(torch.Generator().manual_seed(1), (6, 4, 5))
    jx = np.asarray(jf.positive_unitball(jax.random.PRNGKey(1), (6, 4, 5)))
    assert x.shape == jx.shape == (6, 4, 5)
    for arr in (x.numpy(), jx):
        assert (arr >= 0).all() and (arr <= 1).all()
        np.testing.assert_allclose(arr.reshape(6, -1).sum(1), 1.0,
                                   rtol=1e-6)


def test_filler_device_argument():
    g = torch.Generator().manual_seed(0)
    for x in (tf.gaussian(g, (3,), device="cpu"),
              tf.msra(g, (3, 2), device="cpu"),
              tf.positive_unitball(g, (2, 2), device="cpu"),
              tf.constant((2,), device="cpu"), tf.bilinear((2, 2),
                                                           device="cpu")):
        assert x.device.type == "cpu" and x.dtype == torch.float32


def test_softmax_cross_entropy_ignores_an_out_of_range_label():
    """An ignore label outside [-C, C) (Caffe's usual 255): the JAX
    package's gather fills NaN there and NaN * 0 poisons its loss; the
    port leaves those samples out, as the reference layer does, and gives
    the mean over the valid ones."""
    logits = _np(6, 2)
    labels = np.array([0, 1, 255, 1, 255, 0], np.int32)
    assert np.isnan(float(jl.softmax_cross_entropy(logits, labels,
                                                   ignore_label=255)))
    got = tops.softmax_cross_entropy(torch.as_tensor(logits),
                                     torch.as_tensor(labels),
                                     ignore_label=255)
    keep = labels != 255
    want = jl.softmax_cross_entropy(logits[keep], labels[keep])
    _close(float(got), float(want))
