"""The port's pair maps (``ops/sim_cross_kernels.BilinearPairMaps``) on CPU
tensors, where they run their plain PyTorch versions, against the JAX
package: the Pallas pair-map kernel in the interpreter, the einsum
``sim_cross_bilinear``, and the gradients of ``bilinear_pair_maps``'
custom VJP and of the einsum's autodiff.

Tolerance: float32 throughout; only the order of the sums over D, W and M
differs, so every comparison is within 1e-5 of the compared tensor's
largest |value| (and rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.ops import sim_cross_bilinear as j_bilinear
from mms_answer_selection_tpu.ops.sim_cross_pallas import (
    _pair_maps_forward,
    bilinear_pair_maps as j_pair_maps,
)
from mms_answer_selection_tpu_torch.ops import sim_cross_bilinear
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as T

RTOL = 1e-5

# (N, W1, W2, D, M): ragged widths, one sample, M = 1, D above one 32-wide
# kernel slice, and V4's D = 50 with M = 4
SHAPES = [(3, 5, 7, 6, 2), (1, 4, 9, 33, 1), (2, 8, 6, 50, 4)]


def _operands(n, w1, w2, d, m, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, w1, d)).astype(np.float32)
    a = rng.normal(size=(n, w2, d)).astype(np.float32)
    w = (rng.normal(size=(m, d, d)) * 0.1).astype(np.float32)
    return q, a, w


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_kernel_and_einsum(shape):
    q, a, w = _operands(*shape)
    got = T.bilinear_pair_maps(*map(torch.from_numpy, (q, a, w)))
    assert got.shape == (shape[0], shape[1], shape[2], shape[4])
    _close(got, _pair_maps_forward(jnp.asarray(q), jnp.asarray(a),
                                   jnp.asarray(w), interpret=True))
    _close(got, j_bilinear(q, a, w))
    # on CPU tensors the op is its plain version
    assert torch.equal(got, T.bilinear_pair_maps_plain(
        *map(torch.from_numpy, (q, a, w))))


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_custom_vjp_and_autodiff(shape):
    q, a, w = _operands(*shape, seed=1)
    tq, ta, tw = (torch.from_numpy(x).requires_grad_(True) for x in (q, a, w))
    torch.sum(torch.tanh(T.bilinear_pair_maps(tq, ta, tw))).backward()
    got = (tq.grad, ta.grad, tw.grad)

    def loss(op):
        return lambda *x: jnp.sum(jnp.tanh(op(*x)))

    args = tuple(map(jnp.asarray, (q, a, w)))
    vjp = jax.grad(loss(j_pair_maps), argnums=(0, 1, 2))(*args)
    auto = jax.grad(loss(j_bilinear), argnums=(0, 1, 2))(*args)
    for g, v, u in zip(got, vjp, auto):
        _close(g, v)
        _close(g, u)


def test_grads_plain_are_the_closed_forms():
    q, a, w = _operands(2, 5, 6, 7, 3, seed=2)
    g = np.random.default_rng(3).normal(size=(2, 5, 6, 3)).astype(np.float32)
    dq, da, dw = T.bilinear_pair_maps_grads_plain(
        *map(torch.from_numpy, (q, a, w, g)))
    _, vjp = jax.vjp(j_bilinear, *map(jnp.asarray, (q, a, w)))
    for got, want in zip((dq, da, dw), vjp(jnp.asarray(g))):
        _close(got, want)
    none_qa = T.bilinear_pair_maps_grads_plain(
        *map(torch.from_numpy, (q, a, w, g)), need_qa=False)
    assert none_qa[0] is None and none_qa[1] is None
    assert torch.equal(none_qa[2], dw)


def test_only_the_needed_gradients_are_made():
    q, a, w = (torch.from_numpy(x) for x in _operands(2, 4, 4, 5, 2))
    w.requires_grad_(True)
    T.bilinear_pair_maps(q, a, w).sum().backward()
    assert w.grad is not None and q.grad is None and a.grad is None
    w.grad = None
    w.requires_grad_(False)
    q.requires_grad_(True)
    T.bilinear_pair_maps(q, a, w).sum().backward()
    assert q.grad is not None and w.grad is None


@pytest.mark.parametrize("with_bias", [True, False])
def test_sim_cross_bilinear_gradients_match_jax(with_bias):
    q, a, w = _operands(3, 5, 4, 6, 2, seed=4)
    b = np.random.default_rng(5).normal(size=(2, 5, 4)).astype(np.float32) \
        if with_bias else None
    ts = [torch.from_numpy(x).requires_grad_(True)
          for x in (q, a, w) + ((b,) if with_bias else ())]
    out = sim_cross_bilinear(*ts[:3], ts[3] if with_bias else None)
    torch.sum(torch.tanh(out) * out).backward()
    want = jax.grad(
        lambda *x: jnp.sum(jnp.tanh(j_bilinear(*x)) * j_bilinear(*x)),
        argnums=tuple(range(len(ts))))(
            *map(jnp.asarray, (q, a, w) + ((b,) if with_bias else ())))
    for t, j in zip(ts, want):
        _close(t.grad, j)


@pytest.mark.parametrize("shapes", [
    ((2, 4, 6), (3, 4, 6), (2, 6, 6)),   # batch mismatch
    ((2, 4, 6), (2, 4, 5), (2, 6, 6)),   # D mismatch
    ((2, 4, 6), (2, 4, 6), (2, 6, 5)),   # W not square
    ((4, 6), (2, 4, 6), (2, 6, 6)),      # not 3-D
])
def test_shapes_are_checked(shapes):
    with pytest.raises(ValueError):
        T.bilinear_pair_maps(*(torch.zeros(s) for s in shapes))
