"""The port's retrieval packers and MaxSim scorers against the JAX
package's, at the serving widths D=50, W2=40 with a ragged pool.

The JAX scorers run their Pallas kernels in interpret mode, as the JAX
package's own tests do.  The port runs its plain PyTorch versions here (the
inputs lie on the CPU); ``test_torch_cuda.py`` holds the CUDA kernels
against those plain versions on a card.

Tolerances and why they hold:
* float32 projections: atol = rtol = 1e-5 (summation order only).
* bf16 casts of those projections: equal except <= 1 ulp on <= 0.1% of
  elements (a float32 value that lands within rounding of a bf16 midpoint
  may round either way after a differently ordered sum).
* int8 codes: equal except +-1 on <= 0.01% of elements (same reason, at
  the .5 rounding boundary); scales: rtol 1e-6.
* scores fed the JAX packers' own outputs: 1e-5 of the row's max |score|
  (identical operands; float32 summation order is the only difference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.ops import sim_cross_pallas as J
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as T

D, W1, W2, M = 50, 5, 40, 4      # real D and W2; R = M * W1 = 20
C, C_PAD = 300, 384              # the JAX tiles need a padded pool
NQ = 3
rng = np.random.default_rng(77)

Q = rng.normal(size=(NQ, W1, D)).astype(np.float32) * 0.3
CAND = rng.normal(size=(C, W2, D)).astype(np.float32) * 0.3
W = rng.normal(size=(M, D, D)).astype(np.float32) * 0.05
CAND_PAD = np.concatenate([CAND, np.zeros((C_PAD - C, W2, D), np.float32)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_to_torch(x):
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)


def _bf16_bits(t):
    return t.contiguous().view(torch.int16).numpy().astype(np.int32)


def _assert_scores_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    row_max = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * row_max), \
        np.max(np.abs(got - want) / row_max)


# ------------------------------------------------------------------ packers
def test_project_queries_f32_matches():
    got = T._project(torch.from_numpy(Q), torch.from_numpy(W))
    want = np.asarray(J.project_queries(jnp.asarray(Q), jnp.asarray(W),
                                        dtype=jnp.float32))
    assert got.shape == (NQ, M * W1, D)
    np.testing.assert_allclose(got.numpy(), want[..., :D], rtol=1e-5,
                               atol=1e-5)


def test_project_queries_bf16_cast():
    qw = T.project_queries(torch.from_numpy(Q), torch.from_numpy(W))
    assert qw.shape == (NQ, M * W1, 64) and qw.dtype == torch.bfloat16
    assert torch.all(qw[..., D:-1] == 0) and torch.all(qw[..., -1] == 1)
    want = np.asarray(J.project_queries(jnp.asarray(Q), jnp.asarray(W)))
    ulps = np.abs(_bf16_bits(qw[..., :D])
                  - np.asarray(want[..., :D]).view(np.int16))
    assert ulps.max() <= 1 and np.mean(ulps > 0) <= 1e-3


def test_pack_candidate_pool_bf16():
    w2 = 37                                    # padded tokens get the mask
    toks = CAND[:20, :w2]
    got = T.pack_candidate_pool(torch.from_numpy(toks))
    want = np.asarray(J.pack_candidate_pool(jnp.asarray(toks)))
    assert got.shape == (20, 40, 64)
    np.testing.assert_array_equal(_bf16_bits(got[..., :D]),
                                  want[..., :D].view(np.int16))
    np.testing.assert_array_equal(_bf16_bits(got[..., -1]),
                                  want[..., -1].view(np.int16))
    assert torch.all(got[..., D:-1] == 0)


@pytest.mark.parametrize("w2", [40, 37])
def test_pack_candidate_pool_int8(w2):
    toks = CAND[:, :w2]
    pool, aux = T.pack_candidate_pool_int8(torch.from_numpy(toks))
    jpool, jaux = J.pack_candidate_pool_int8(jnp.asarray(toks))
    jpool, jaux = np.asarray(jpool), np.asarray(jaux, np.float32)
    assert pool.shape == (C, 40, 64) and aux.shape == (C, 2)
    diff = np.abs(pool.numpy()[..., :D].astype(np.int32)
                  - jpool[..., :D].astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-4
    assert torch.all(pool[..., D:] == 0)
    np.testing.assert_allclose(aux.float().numpy(), jaux, rtol=1e-6)
    # padded token rows duplicate token 0
    assert torch.equal(pool[:, w2:], pool[:, :1].expand(-1, 40 - w2, -1))


def test_project_queries_int8():
    qi, qs = T.project_queries_int8(torch.from_numpy(Q), torch.from_numpy(W))
    jqi, jqs = J.project_queries_int8(jnp.asarray(Q), jnp.asarray(W))
    assert qi.shape == (NQ, M * W1, 64) and qs.dtype == torch.float32
    diff = np.abs(qi.numpy()[..., :D].astype(np.int32)
                  - np.asarray(jqi)[..., :D].astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-4
    np.testing.assert_allclose(qs.numpy(), np.asarray(jqs), rtol=1e-6)


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, 127.0, -127.0]])
    codes, scale = T._quantize(x, torch.tensor([[127.0]]))
    assert float(scale) == 1.0
    assert codes.tolist() == [[0, 2, 2, 0, 127, -127]]
    zero, zscale = T._quantize(torch.zeros(1, 3), torch.zeros(1, 1))
    assert torch.all(zero == 0) and torch.isfinite(zscale).all()


# ------------------------------------------------------------------ scorers
def test_bf16_scorer_matches_jax_kernel_on_jax_operands():
    qw = J.project_queries(jnp.asarray(Q), jnp.asarray(W))
    pool = J.mask_out_candidates(J.pack_candidate_pool(jnp.asarray(CAND_PAD)),
                                 C)
    want = np.asarray(J.bilinear_maxsim_scores(qw, pool, interpret=True))
    got = T.bilinear_maxsim_scores(_bf16_to_torch(qw),
                                   _bf16_to_torch(pool)[:C])
    assert got.shape == (NQ, C)
    _assert_scores_close(got.numpy(), want[:, :C])


@pytest.mark.parametrize("layout", ["candmaj", "tokmaj"])
def test_int8_scorer_matches_both_jax_layouts(layout):
    qw, qs = J.project_queries_int8(jnp.asarray(Q), jnp.asarray(W))
    pool, aux = J.pack_candidate_pool_int8(jnp.asarray(CAND_PAD))
    aux = J.mask_out_candidates_int8(aux, C)
    want = np.asarray(J.bilinear_maxsim_scores_int8(
        qw, qs, *J.pack_candidate_pool_int8(jnp.asarray(CAND_PAD),
                                            layout=layout)[:1], aux,
        layout=layout, interpret=True))
    # the port scores the candidate-major packing of the same codes
    got = T.bilinear_maxsim_scores_int8(
        _t(qw), _t(qs), _t(pool)[:C], _bf16_to_torch(aux)[:C])
    _assert_scores_close(got.numpy(), want[:, :C])
    # padding candidates score exactly the bf16 mask, as in the reference
    got_pad = T.bilinear_maxsim_scores_int8(
        _t(qw), _t(qs), _t(pool), _bf16_to_torch(aux))
    np.testing.assert_array_equal(got_pad.numpy()[:, C:], want[:, C:])


def test_reference_matches_jax_reference():
    got = T.bilinear_maxsim_scores_reference(
        torch.from_numpy(Q), torch.from_numpy(CAND[:64]), torch.from_numpy(W))
    want = J.bilinear_maxsim_scores_reference(jnp.asarray(Q),
                                              jnp.asarray(CAND[:64]),
                                              jnp.asarray(W))
    _assert_scores_close(got.numpy(), want)


@pytest.mark.parametrize("w2", [40, 37])
def test_port_pipelines_approximate_the_f32_reference(w2):
    q, cand, w = map(torch.from_numpy, (Q, CAND[:, :w2], W))
    ref = T.bilinear_maxsim_scores_reference(q, cand, w).numpy()
    bf16 = T.bilinear_maxsim_scores(T.project_queries(q, w),
                                    T.pack_candidate_pool(cand)).numpy()
    int8 = T.bilinear_maxsim_scores_int8(*T.project_queries_int8(q, w),
                                         *T.pack_candidate_pool_int8(cand))
    _assert_scores_close(bf16, ref, rtol=1e-2)
    _assert_scores_close(int8.numpy(), ref, rtol=5e-2)


def test_masked_candidates_never_win():
    q, cand, w = map(torch.from_numpy, (Q, CAND, W))
    pool = T.mask_out_candidates(T.pack_candidate_pool(cand), 250)
    s = T.bilinear_maxsim_scores(T.project_queries(q, w), pool)
    assert torch.all(s[:, 250:] < -1e29) and torch.all(s[:, :250] > -1e29)
    pool8, aux = T.pack_candidate_pool_int8(cand)
    aux = T.mask_out_candidates_int8(aux, 250)
    s8 = T.bilinear_maxsim_scores_int8(*T.project_queries_int8(q, w), pool8,
                                       aux)
    assert torch.all(s8[:, 250:] == aux[250:, 1].float())


def test_cpu_operands_take_the_plain_version_without_launching():
    q, cand, w = map(torch.from_numpy, (Q, CAND[:50], W))
    qw, pool = T.project_queries(q, w), T.pack_candidate_pool(cand)
    before = dict(T.LAUNCH_COUNTS)
    assert torch.equal(T.bilinear_maxsim_scores(qw, pool),
                       T.bilinear_maxsim_scores_plain(qw, pool))
    assert T.LAUNCH_COUNTS == before


def test_wrappers_reject_bad_operands():
    q, cand, w = map(torch.from_numpy, (Q, CAND[:8], W))
    qw, pool = T.project_queries(q, w), T.pack_candidate_pool(cand)
    with pytest.raises(ValueError):           # no kernel on this device
        T.bilinear_maxsim_scores(qw.to("meta"), pool.to("meta"))
    with pytest.raises(ValueError):           # Dp mismatch
        T.bilinear_maxsim_scores(qw[..., :32], pool)
    with pytest.raises(ValueError):           # empty pool
        T.bilinear_maxsim_scores(qw, pool[:0])
    qi, qs = T.project_queries_int8(q, w)
    p8, aux = T.pack_candidate_pool_int8(cand)
    with pytest.raises(ValueError):           # aux does not fit the pool
        T.bilinear_maxsim_scores_int8(qi, qs, p8, aux[:4])


# ------------------------------------------------------ MaxSim launch plans
# The plan of the CUDA kernels is pure Python (``maxsim_geometry``), so it
# is checked here: the kernels walk units u = block, block + grid, ... and
# unit u is query group u % n_groups against the pool tiles of range
# u // n_groups.  Legal wgmma widths from the PTX ISA: f32 += bf16 * bf16
# takes any multiple of 8 up to 256; s32 += s8 * s8 takes 8, 16, 24, 32,
# then multiples of 16 up to 256.
_S8_WIDTHS = {8, 16, 24, 32} | set(range(48, 257, 16))
# V4 and V4_WIDE (Dp 304 bf16, 320 int8 / int4: K-sliced), R = 800 (W1 =
# 200: resident at Dp 64, K-sliced at Dp 304 / 320), ragged everything
_PLAN_SWEEP = [(nq, r, c, w2p, dp, dtype)
               for nq, r, c in [(1, 160, 262_144), (256, 160, 262_144),
                                (16, 160, 8192), (5, 160, 8192 + 37),
                                (1, 20, 1), (3, 20, 37), (70, 160, 200),
                                (1, 160, 2000), (9, 3 * 4, 1000),
                                (3, 800, 301), (32, 800, 8192)]
               for w2p, dp, dtype in [(40, 64, "bf16"), (40, 64, "int8"),
                                      (40, 64, "int4"), (8, 128, "bf16"),
                                      (24, 16, "bf16"), (8, 256, "int8"),
                                      (24, 32, "int4"), (296, 64, "bf16"),
                                      (512, 96, "int8"), (40, 304, "bf16"),
                                      (40, 320, "int8"), (40, 320, "int4"),
                                      (296, 320, "int8")]]


def _visits(geo):
    """How often the kernels visit each (query group, pool tile): every
    block walks units u = block, block + grid, ...; a unit is group u %
    n_groups against the tiles of range u // n_groups (each tile with all
    of its slabs)."""
    seen = np.zeros((geo.n_groups, geo.n_tiles), np.int32)
    for block in range(geo.grid):
        for u in range(block, geo.units, geo.grid):
            t0 = u // geo.n_groups * geo.tiles_per_unit
            seen[u % geo.n_groups, t0:t0 + geo.tiles_per_unit] += 1
    return seen


@pytest.mark.parametrize("shape", _PLAN_SWEEP)
def test_maxsim_plan_covers_every_pair_once(shape):
    nq, r, c, w2p, dp, dtype = shape
    geo = T.maxsim_geometry(*shape)
    assert np.all(_visits(geo) == 1)
    rows = np.zeros(nq * r, np.int64)          # query rows, by group
    for grp in range(geo.n_groups):
        rows[grp * geo.g * r:(grp + 1) * geo.g * r] += 1
    assert np.all(rows == 1)
    cands = np.zeros(c, np.int64)              # candidates, by tile
    for t in range(geo.n_tiles):
        cands[t * geo.n_c:(t + 1) * geo.n_c] += 1
    assert np.all(cands == 1)
    toks = np.zeros(w2p, np.int64)             # a candidate's tokens, by slab
    for s in range(geo.slabs):
        toks[s * geo.w2s:(s + 1) * geo.w2s] += 1
    assert np.all(toks == 1)


@pytest.mark.parametrize("shape", _PLAN_SWEEP)
def test_maxsim_plan_fits_the_card(shape):
    nq, r, c, w2p, dp, dtype = shape
    geo = T.maxsim_geometry(*shape)
    assert geo.n in (_S8_WIDTHS if dtype != "bf16" else range(8, 257, 8))
    assert geo.n in (240, 256)                 # the widths that are built
    assert geo.w2s % 8 == 0 and geo.n_c * geo.w2s <= geo.n
    assert 1 <= geo.n_c <= 32 and (geo.slabs == 1 or geo.n_c == 1)
    assert 1 <= geo.g <= min(nq, 8) and 2 <= geo.stages <= 6
    if geo.k_sliced:   # two rings of two or three slots
        assert geo.stages in (4, 6)
    assert geo.smem == T.maxsim_smem(r, dp, dtype, geo.g, geo.n_c, geo.n,
                                     geo.stages, geo.k_sliced) <= 232_448
    assert 1 <= geo.grid <= min(132, geo.units) and geo.grid <= 65_535


def test_maxsim_plan_keeps_the_serving_shape_whole():
    """V4 at 256 queries x 262,144: six whole candidates a 240-column tile
    (the kernel's own path for W2P = 40), no padded query rows (4 x 160 =
    10 row tiles), one wave of blocks."""
    geo = T.maxsim_geometry(256, 160, 262_144, 40, 64, "bf16")
    assert (geo.n, geo.n_c, geo.g, geo.grid) == (240, 6, 4, 132)
    assert T.maxsim_geometry(1, 160, 262_144, 40, 64, "int8").g == 1


def test_maxsim_plan_slices_k_only_where_it_must():
    """Rows of at most 256 bytes whose query rows fit keep the resident
    plan, V4's included, so its kernels are the ones built before; rows
    past 256 bytes, or R = 800 at V4_WIDE's Dp, are K-sliced, in 128-byte
    spans whose last one may run past Dp."""
    for nq in (1, 16, 256):
        for dtype in ("bf16", "int8", "int4"):
            assert not T.maxsim_geometry(nq, 160, 262_144, 40, 64,
                                         dtype).k_sliced
            assert not T.maxsim_geometry(nq, 800, 8192, 40, 64,
                                         dtype).k_sliced
    for dtype, dp in (("bf16", 304), ("int8", 320), ("int4", 320),
                      ("bf16", 144)):
        for r in (160, 800):
            assert T.maxsim_geometry(256, r, 262_144, 40, dp, dtype).k_sliced
    assert T.maxsim_span(608) == T.maxsim_span(320) == 128
    assert (T.maxsim_span(128), T.maxsim_span(64), T.maxsim_span(96)) \
        == (128, 64, 32)
    # the K-sliced V4_WIDE scan still fills a wave with six candidates a
    # 240-column tile
    geo = T.maxsim_geometry(256, 160, 262_144, 40, 304, "bf16")
    assert (geo.n, geo.n_c, geo.grid) == (240, 6, 132)


@pytest.mark.parametrize("shape", [(1, 160, 10, 44, 64, "bf16"),
                                   (1, 160, 10, 40, 72, "bf16"),
                                   (1, 160, 10, 40, 48, "int8"),
                                   (1, 160, 10, 40, 80, "int4"),
                                   (0, 160, 10, 40, 64, "bf16"),
                                   (1, 10_000, 10, 40, 128, "bf16")])
def test_maxsim_plan_refuses_what_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        T.maxsim_geometry(*shape)
