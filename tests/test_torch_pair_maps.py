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


@pytest.mark.parametrize("shape", [(2, 65, 100, 300, 4), (1, 100, 65, 300, 2),
                                   (2, 130, 9, 50, 4)])
def test_long_sentences_match_pallas_kernel_and_custom_vjp(shape):
    """W1 != W2 past 64 (the CUDA kernels tile them) at V4_WIDE's D = 300:
    the forward against the Pallas kernel, the three gradients of a given
    dL/dout against the custom VJP.  Operands at the card tests' scales
    (0.3, 0.3, 0.05), so the map stays O(1); same 1e-5 tolerance."""
    q, a, w = _operands(*shape, seed=6)
    q, a, w = q * 0.3, a * 0.3, w * 0.5
    g = np.random.default_rng(7).normal(
        size=(shape[0], shape[1], shape[2], shape[4])).astype(np.float32)
    tq, ta, tw = (torch.from_numpy(x).requires_grad_(True) for x in (q, a, w))
    out = T.bilinear_pair_maps(tq, ta, tw)
    out.backward(torch.from_numpy(g))
    _close(out, _pair_maps_forward(jnp.asarray(q), jnp.asarray(a),
                                   jnp.asarray(w), interpret=True))
    _, vjp = jax.vjp(j_pair_maps, *map(jnp.asarray, (q, a, w)))
    for got, want in zip((tq.grad, ta.grad, tw.grad), vjp(jnp.asarray(g))):
        _close(got, want)


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


# ------------------------------------------------- the kernels' launch plans
# The CUDA kernels run only on a card; what the wrappers hand them (the
# split of rows, columns and samples across blocks, threads and shared
# memory) is plain Python, held here to the kernels' own limits.
SMEM_LIMIT = 232448          # dynamic shared memory of one sm_90 block
GEO_WIDTHS = (1, 7, 40, 64, 65, 100, 200, 512)
GEO_DS = (1, 31, 33, 50, 64, 300, 301, 512, 1000, 4096)
GEO_NS = (1, 7, 50, 1024)


def _fwd_fits(geo, n, w1, w2, d, m):
    parts = -(-w1 // geo.rows)
    assert 1 <= geo.rows <= min(w1, 40) and geo.rows * (parts - 1) < w1
    assert geo.te % 8 == 0 and geo.te * (geo.col_tiles - 1) < d \
        <= geo.te * geo.col_tiles
    # W2's tiles cover it exactly, none empty
    w2_tiles = -(-w2 // geo.w2t)
    assert 1 <= geo.w2t <= w2 and geo.w2t * (w2_tiles - 1) < w2
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    # a warp per two 16-column fragments of P^T; a 2-row x 8-column tile
    # of the second product per thread
    assert geo.threads // 32 * 2 >= geo.te * 4 // 16
    assert -(-geo.rows // 8) * 4 * -(-geo.w2t // 8) <= geo.threads
    assert parts * geo.col_tiles * w2_tiles <= 65535
    assert 0 < geo.smem <= SMEM_LIMIT


def _dw_fits(geo, n, w1, w2, d, m):
    # the chunks cover samples 0..N exactly, none of them empty
    assert geo.chunks == -(-n // geo.n_per)
    assert (geo.chunks - 1) * geo.n_per < n <= geo.chunks * geo.n_per
    assert geo.chunks <= 65535
    assert 1 <= geo.d_rows <= d and geo.te % 8 == 0 and geo.te <= 64
    # W1's tiles cover a sample's rows exactly, none empty
    assert 1 <= geo.w1t <= w1 and geo.w1t * (-(-w1 // geo.w1t) - 1) < w1
    # one 8 x 8 tile of the panel per thread, for each of the 4 measures
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    assert -(-geo.d_rows // 8) * (geo.te // 8) * 4 <= geo.threads
    assert 0 < geo.smem <= SMEM_LIMIT


def _qa_fits(geo, n, w1, w2, d, m):
    assert geo.te % 8 == 0 and 8 <= geo.te <= 64
    # measure groups cover 0..M exactly, none empty
    assert 1 <= geo.m_per <= m and geo.m_per * (-(-m // geo.m_per) - 1) < m
    for role, kn, rn in ((geo.dq, w2, w1), (geo.da, w1, w2)):
        # whole samples with all of K, or one sample in chunks of x's rows
        # that cover K exactly, none empty; at most 128 rows of x
        assert 1 <= role.samples <= n and 1 <= role.k_rows <= kn
        assert role.samples == 1 or role.k_rows == kn
        assert role.k_rows * (-(-kn // role.k_rows) - 1) < kn
        assert role.samples * role.k_rows <= 128
        # output row tiles cover R exactly, none empty; a 4 x 8 tile of
        # the output per thread of 256
        assert 1 <= role.r_rows <= rn
        assert role.r_rows * (-(-rn // role.r_rows) - 1) < rn
        assert role.samples * -(-role.r_rows // 4) * (geo.te // 8) <= 256
        assert role.blocks == -(-n // role.samples) * -(-rn // role.r_rows) \
            * -(-d // geo.te)
        assert -(-rn // role.r_rows) * -(-d // geo.te) <= 65535
        assert 0 < role.smem <= SMEM_LIMIT


@pytest.mark.parametrize("d", GEO_DS)
def test_launch_plans_fit_the_kernels(d):
    for w1 in GEO_WIDTHS:
        for w2 in GEO_WIDTHS:
            for n in GEO_NS:
                _fwd_fits(T.pair_maps_fwd_geometry(n, w1, w2, d, 4),
                          n, w1, w2, d, 4)
                _dw_fits(T.pair_maps_bwd_w_geometry(n, w1, w2, d, 4),
                         n, w1, w2, d, 4)
                _qa_fits(T.pair_maps_bwd_qa_geometry(n, w1, w2, d, 4),
                         n, w1, w2, d, 4)


@pytest.mark.parametrize("shape", [(50, 40, 40, 50, 4), (1024, 40, 40, 50, 4),
                                   (50, 40, 40, 300, 4), (1600, 40, 40, 50, 4),
                                   (7, 40, 7, 64, 5), (3, 64, 1, 301, 9),
                                   (1024, 40, 40, 300, 4),
                                   (50, 65, 100, 300, 4),
                                   (7, 200, 200, 50, 4)])
def test_launch_plans_depend_only_on_the_shape(shape):
    plans = (T.pair_maps_fwd_geometry, T.pair_maps_bwd_w_geometry,
             T.pair_maps_bwd_qa_geometry)
    first = tuple(plan(*shape) for plan in plans)
    for plan in plans:
        plan.cache_clear()
    again = tuple(plan(*shape) for plan in plans)
    assert first == again
    _fwd_fits(first[0], *shape)
    _dw_fits(first[1], *shape)
    _qa_fits(first[2], *shape)


def test_w_up_to_64_keeps_its_plans():
    """Tiling W1 and W2 leaves every V4 / V4_WIDE plan whole: one W2 tile
    in the forward, one W1 tile in dW."""
    for n in (1, 50, 1024, 1600):
        for d in (50, 300):
            assert T.pair_maps_fwd_geometry(n, 40, 40, d, 4).w2t == 40
            assert T.pair_maps_bwd_w_geometry(n, 40, 40, d, 4).w1t == 40
    assert T.pair_maps_fwd_geometry(50, 40, 201, 50, 4).w2t == 101
    assert T.pair_maps_bwd_w_geometry(7, 512, 512, 300, 4).w1t < 512


def test_bwd_qa_plan_tiles_rows_across_samples():
    """V4 at batch 1024: three samples' 40 rows (120) a block for both dQ
    and dA, so one staged slab of W_m serves 120 rows; at batch 50 the
    blocks shrink to one sample so that 100 blocks run; past 128 rows of
    x a sample is cut into equal chunks."""
    geo = T.pair_maps_bwd_qa_geometry(1024, 40, 40, 300, 4)
    assert geo.te == 60 + 4 and geo.dq[:3] == geo.da[:3] == (3, 40, 40)
    assert geo.m_per == 4                     # no partial outputs
    small = T.pair_maps_bwd_qa_geometry(50, 40, 40, 50, 4)
    assert small.dq.samples == small.da.samples == 1
    assert small.dq.blocks + small.da.blocks == 100
    assert small.m_per == 2                   # 200 blocks in two groups
    wide = T.pair_maps_bwd_qa_geometry(4, 40, 200, 50, 4)
    assert wide.dq.k_rows == 100 and wide.da.r_rows == 100


@pytest.mark.parametrize("n", [1, 2, 7, 50, 65, 68, 1024, 1600, 100_000])
def test_dw_chunks_cover_the_batch(n):
    geo = T.pair_maps_bwd_w_geometry(n, 40, 40, 50, 4)
    starts = [c * geo.n_per for c in range(geo.chunks)]
    ends = [min(n, s + geo.n_per) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e > s for s, e in zip(starts, ends))
    assert all(a == b for a, b in zip(ends, starts[1:]))


@pytest.mark.parametrize("plan", [T.pair_maps_fwd_geometry,
                                  T.pair_maps_bwd_w_geometry,
                                  T.pair_maps_bwd_qa_geometry])
@pytest.mark.parametrize("shape", [
    (50, 40, 40, 50, 65536),                   # M past the grid
    (50, -1, 40, 50, 4), (50, 40, -1, 50, 4),  # negative widths
    (0, 40, 40, 50, 4), (50, 0, 40, 50, 4),    # empty
    (50, 40, 40, 0, 4), (50, 40, 40, 50, 0)])
def test_launch_plans_refuse_what_the_kernels_do_not_take(plan, shape):
    with pytest.raises(ValueError):
        plan(*shape)
