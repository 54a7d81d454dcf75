"""The generic net's ops in the port against the JAX package's, on CPU:
padded, pyramid and stochastic pooling (``ops/pooling.py``), the layer zoo
(``ops/zoo.py``) and the LSTM / RNN (``ops/recurrent.py``).

Each op gets the same seeded numpy inputs in both packages; its output and
its gradients (of the sum of the output times a fixed random cotangent,
with respect to every float input) are compared.  Tolerance: within 1e-5
of each array's largest |value| (float32; the two sum in other orders),
exact for integer and index outputs and where both give -inf (pooling
windows wholly in the padding).  Stochastic pooling in train mode
draws from each package's own generator, so it is held to its definition
and to its test-phase expectation statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.ops import pooling as JPool
from mms_answer_selection_tpu.ops import recurrent as JR
from mms_answer_selection_tpu.ops import zoo as JZ
from mms_answer_selection_tpu_torch.ops import pooling as TPool
from mms_answer_selection_tpu_torch.ops import recurrent as TR
from mms_answer_selection_tpu_torch.ops import zoo as TZ

RTOL = 1e-5


def _close(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # windows wholly in the padding are -inf in both (SPP's last levels)
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    got, want = np.where(inf, 0, got), np.where(inf, 0, want)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} x {scale:.3e}"


def _check(jfn, tfn, *args, seed=0):
    """Forward and gradients of jfn / tfn on the same numpy ``args``."""
    jargs = [jnp.asarray(a) for a in args]
    jout = jfn(*jargs)
    targs = [torch.tensor(a, requires_grad=np.issubdtype(a.dtype,
                                                         np.floating))
             for a in args]
    tout = tfn(*targs)
    _close(tout.detach().numpy(), jout, "forward")
    cot = np.random.default_rng(seed + 99).normal(
        size=np.shape(jout)).astype(np.float32)
    floats = [i for i, a in enumerate(args)
              if np.issubdtype(a.dtype, np.floating)]
    jgrads = jax.grad(lambda *fa: jnp.sum(jfn(*[
        fa[floats.index(i)] if i in floats else jargs[i]
        for i in range(len(args))]) * cot),
        argnums=tuple(range(len(floats))))(*[jargs[i] for i in floats])
    (tout * torch.as_tensor(cot)).sum().backward()
    for k, i in enumerate(floats):
        _close(targs[i].grad.numpy(), jgrads[k], f"grad of input {i}")


def _x(*shape, seed=0, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) if positive else x


# ------------------------------------------------------------------ pooling

@pytest.mark.parametrize("mode", ["max", "ave"])
@pytest.mark.parametrize("k,s,ph,pw", [(3, 2, 1, 1), (2, 2, 0, 1),
                                       (3, 1, 1, 0), (3, 3, 0, 0),
                                       (4, 3, 2, 1)])
def test_pool2d_padded(mode, k, s, ph, pw):
    x = _x(2, 7, 9, 3, seed=k * 10 + s)
    kw = dict(stride_h=s, stride_w=s, pad_h=ph, pad_w=pw, mode=mode)
    _check(lambda a: JPool.pool2d_padded(a, k, k, **kw),
           lambda a: TPool.pool2d_padded(a, k, k, **kw), x)


@pytest.mark.parametrize("height", [1, 2, 3])
@pytest.mark.parametrize("mode", ["max", "ave"])
def test_spatial_pyramid_pool(height, mode):
    x = _x(2, 7, 5, 3, seed=height)
    _check(lambda a: JPool.spatial_pyramid_pool(a, height, mode=mode),
           lambda a: TPool.spatial_pyramid_pool(a, height, mode=mode), x)


@pytest.mark.parametrize("k,s", [(2, 2), (3, 2), (2, 1)])
def test_stochastic_pool_test_phase(k, s):
    x = _x(2, 5, 6, 3, seed=k + s, positive=True)
    _check(lambda a: JPool.stochastic_pool2d(a, k, k, stride_h=s,
                                             stride_w=s, train=False),
           lambda a: TPool.stochastic_pool2d(a, k, k, stride_h=s,
                                             stride_w=s, train=False), x)


def test_stochastic_pool_train_samples_by_value():
    """Train mode picks one element of each window with probability
    proportional to its value: every output is an element of its window,
    the gradient is one-hot, and the mean over draws is the test phase's
    sum(x^2) / sum(x) (within 4 standard errors)."""
    x = _x(1, 4, 4, 2, seed=5, positive=True)
    xt = torch.tensor(x, requires_grad=True)
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(2000):
        draws.append(TPool.stochastic_pool2d(xt, 2, 2, stride_h=2,
                                              stride_w=2, generator=gen))
    y = draws[0]
    y.sum().backward()
    assert sorted(np.unique(xt.grad.numpy()).tolist()) == [0.0, 1.0]
    assert int(xt.grad.sum()) == y.numel()
    windows = x.reshape(1, 2, 2, 2, 2, 2).transpose(0, 1, 3, 5, 2, 4) \
        .reshape(1, 2, 2, 2, 4)
    stack = torch.stack(draws).detach().numpy()
    assert np.all(np.any(stack[..., None] == windows[None], axis=-1))
    want = (windows ** 2).sum(-1) / windows.sum(-1)
    var = (windows ** 3).sum(-1) / windows.sum(-1) - want ** 2
    se = np.sqrt(var / len(draws))
    assert np.all(np.abs(stack.mean(0) - want) <= 4 * se + 1e-6)
    with pytest.raises(ValueError, match="generator"):
        TPool.stochastic_pool2d(xt, 2, 2, train=True)


# --------------------------------------------------------------------- zoo

NEURONS = {
    "relu": dict(negative_slope=0.1), "sigmoid": {}, "tanh": {},
    "elu": dict(alpha=0.5), "bnll": {},
    "power": dict(power=2.0, scale=3.0, shift=1.0),
    "exp": dict(base=2.0, scale=0.5, shift=0.1), "absval": {},
}


@pytest.mark.parametrize("name", sorted(NEURONS))
def test_neurons(name):
    kw = NEURONS[name]
    _check(lambda a: getattr(JZ, name)(a, **kw),
           lambda a: getattr(TZ, name)(a, **kw), _x(3, 5, seed=len(name)))


def test_log_and_threshold():
    x = _x(3, 5, seed=1, positive=True) + 0.1
    for base in (-1.0, 2.0):
        _check(lambda a: JZ.log(a, base=base, scale=2.0, shift=0.5),
               lambda a: TZ.log(a, base=base, scale=2.0, shift=0.5), x)
    x = _x(3, 5, seed=2)
    np.testing.assert_array_equal(TZ.threshold(torch.tensor(x),
                                               threshold=0.3).numpy(),
                                  JZ.threshold(jnp.asarray(x), threshold=0.3))


def test_prelu_and_scale():
    x, s, b = _x(2, 3, 4, 5), _x(5, seed=1), _x(5, seed=2)
    _check(JZ.prelu, TZ.prelu, x, s)
    _check(JZ.scale, TZ.scale, x, s, b)


@pytest.mark.parametrize("across", [False, True])
@pytest.mark.parametrize("norm_var", [False, True])
def test_mvn(across, norm_var):
    kw = dict(across_channels=across, normalize_variance=norm_var)
    _check(lambda a: JZ.mvn(a, **kw), lambda a: TZ.mvn(a, **kw),
           _x(2, 4, 5, 3, seed=3))


@pytest.mark.parametrize("size", [3, 5])
def test_lrn_both_modes(size):
    x = _x(2, 5, 6, 7, seed=size)
    kw = dict(local_size=size, alpha=2.0, beta=0.75)
    _check(lambda a: JZ.lrn_across_channels(a, k=1.5, **kw),
           lambda a: TZ.lrn_across_channels(a, k=1.5, **kw), x)
    _check(lambda a: JZ.lrn_within_channel(a, **kw),
           lambda a: TZ.lrn_within_channel(a, **kw), x)


@pytest.mark.parametrize("group,stride,pad,dil", [(1, 2, 0, 1), (2, 2, 1, 1),
                                                  (2, 1, 0, 2),
                                                  (4, 3, 1, 1)])
def test_deconv2d_with_groups(group, stride, pad, dil):
    cin, og, k = 4, 3, 3
    x, w, b = _x(2, 5, 4, cin), _x(cin, og, k, k, seed=1), \
        _x(og * group, seed=2)
    kw = dict(stride=stride, pad=pad, dilation=dil, group=group)
    _check(lambda a, ww, bb: JZ.deconv2d(a, ww, bb, **kw),
           lambda a, ww, bb: TZ.deconv2d(a, ww, bb, **kw), x, w, b)


@pytest.mark.parametrize("op,coeffs", [("sum", [1.0, -2.0, 0.5]),
                                       ("sum", None), ("prod", None),
                                       ("max", None)])
def test_eltwise(op, coeffs):
    xs = [_x(3, 4, seed=i) for i in range(3)]
    _check(lambda *a: JZ.eltwise(list(a), operation=op, coeffs=coeffs),
           lambda *a: TZ.eltwise(list(a), operation=op, coeffs=coeffs), *xs)
    if coeffs:
        with pytest.raises(ValueError):
            TZ.eltwise([torch.ones(2)] * 2, operation="sum", coeffs=coeffs)


@pytest.mark.parametrize("op", ["sum", "asum", "sumsq", "mean"])
@pytest.mark.parametrize("axis,axes", [(0, None), (1, None), (-1, None),
                                       (0, (1, 2))])
def test_reduction_axes(op, axis, axes):
    kw = dict(operation=op, axis=axis, coeff=0.5, axes=axes)
    _check(lambda a: JZ.reduction(a, **kw), lambda a: TZ.reduction(a, **kw),
           _x(2, 3, 4, seed=7))


@pytest.mark.parametrize("axis", [None, 1, 2])
@pytest.mark.parametrize("out_max_val", [False, True])
def test_argmax(axis, out_max_val):
    x = _x(3, 4, 5, seed=8)
    kw = dict(top_k=2, out_max_val=out_max_val, axis=axis)
    np.testing.assert_array_equal(TZ.argmax(torch.tensor(x), **kw).numpy(),
                                  np.asarray(JZ.argmax(jnp.asarray(x), **kw)))


@pytest.mark.parametrize("ignore", [None, 1])
def test_accuracy_and_reindex(ignore):
    rng = np.random.default_rng(9)
    s, lab = _x(8, 5, seed=9), rng.integers(0, 5, (8,)).astype(np.int32)
    got = TZ.accuracy(torch.tensor(s), torch.tensor(lab), top_k=2,
                      ignore_label=ignore)
    want = JZ.accuracy(jnp.asarray(s), jnp.asarray(lab), top_k=2,
                       ignore_label=ignore)
    assert float(got) == float(want)
    perm = np.asarray([3, 0, 0, 7], np.int32)
    _check(lambda a: JZ.batch_reindex(a, jnp.asarray(perm)),
           lambda a: TZ.batch_reindex(a, torch.tensor(perm)), s)


@pytest.mark.parametrize("capacity", [None, 2, 6])
def test_filter_rows_with_capacity(capacity):
    x, y = _x(6, 3), _x(6, 2, 2, seed=1)
    sel = np.asarray([0.0, 1.0, 0.0, 2.0, 1.0, 0.0], np.float32)
    jo, jc = JZ.filter_rows((jnp.asarray(x), jnp.asarray(y)),
                            jnp.asarray(sel), capacity=capacity)
    to, tc = TZ.filter_rows((torch.tensor(x), torch.tensor(y)),
                            torch.tensor(sel), capacity=capacity)
    assert int(tc) == int(jc)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _check(lambda a: JZ.filter_rows(a, jnp.asarray(sel),
                                    capacity=capacity)[0],
           lambda a: TZ.filter_rows(a, torch.tensor(sel),
                                    capacity=capacity)[0], x)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("sel", [[0, 1, 0, 1], [0, 0, 0, 0]])
def test_filter_reduce(op, sel):
    x = _x(4, 3, seed=4)
    sel = np.asarray(sel, np.float32)
    got = TZ.filter_reduce(torch.tensor(x), torch.tensor(sel), operation=op)
    want = JZ.filter_reduce(jnp.asarray(x), jnp.asarray(sel), operation=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# --------------------------------------------------------------- recurrent

def _params(init, seed, d, h):
    p = init(jax.random.PRNGKey(seed), d, h)
    return {k: np.asarray(v) + 0.1 * _x(*v.shape, seed=seed + len(k))
            for k, v in p.items()}


@pytest.mark.parametrize("with_cont", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "rnn"])
def test_recurrent_with_cont(kind, with_cont):
    t_len, n, d, h = 6, 3, 4, 5
    x = _x(t_len, n, d, seed=11)
    cont = np.ones((t_len, n), np.float32)
    cont[0] = 0.0
    cont[3, 1] = 0.0                       # a sequence restarts mid-batch
    init = JR.lstm_init if kind == "lstm" else JR.rnn_init
    p = _params(init, 3, d, h)
    keys = sorted(p)
    japply = JR.lstm_apply if kind == "lstm" else JR.rnn_apply
    tapply = TR.lstm_apply if kind == "lstm" else TR.rnn_apply
    c = cont if with_cont else None

    def jf(xx, *vals):
        return japply(dict(zip(keys, vals)), xx,
                      cont=None if c is None else jnp.asarray(c))[0]

    def tf(xx, *vals):
        return tapply(dict(zip(keys, vals)), xx,
                      cont=None if c is None else torch.tensor(c))[0]

    _check(jf, tf, x, *[p[k] for k in keys])


@pytest.mark.parametrize("kind", ["lstm", "rnn"])
def test_recurrent_init_shapes(kind):
    gen = torch.Generator().manual_seed(0)
    t = (TR.lstm_init if kind == "lstm" else TR.rnn_init)(gen, 4, 5)
    j = (JR.lstm_init if kind == "lstm" else JR.rnn_init)(
        jax.random.PRNGKey(0), 4, 5)
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: tuple(v.shape) for k, v in j.items()}
    for k in t:
        if k.startswith("b"):
            assert not t[k].any()
