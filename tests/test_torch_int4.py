"""The port's int4 retrieval operands and scorer against the JAX package's,
at the serving widths D=50, W2=40 with a ragged pool.

The JAX scorer runs its Pallas kernel in interpret mode (where its +-7
operands stay int8, value-identical to int4).  The port stores the pool
two codes per byte; its scorer runs the plain version here (CPU tensors),
and ``test_torch_cuda.py`` holds the ``maxsim_int4`` kernel against it.

Tolerances and why they hold:
* the percentile: equal bits (the same two order statistics and the same
  float32 interpolation, with the one fused multiply-add of XLA's CPU
  lowering).
* candidate scales: equal bf16 bits; codes: equal (same scale, same
  float32 division, the same round-half-even).
* query codes: equal except +-1 on <= 0.01% of elements, query scales
  rtol 1e-6 (the float32 projection's summation order differs, as for
  int8).
* scores fed the JAX packers' own outputs: 1e-5 of the row's max |score|
  (identical operands; float32 summation order is the only difference);
  padding candidates score the mask exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.ops import sim_cross_pallas as J
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as T

D, W1, W2, M = 50, 5, 40, 4
C, C_PAD = 300, 384              # the JAX tiles need a padded pool
NQ = 3
rng = np.random.default_rng(44)

Q = rng.normal(size=(NQ, W1, D)).astype(np.float32) * 0.3
CAND = rng.normal(size=(C, W2, D)).astype(np.float32) * 0.3
W = rng.normal(size=(M, D, D)).astype(np.float32) * 0.05
CAND_PAD = np.concatenate([CAND, np.zeros((C_PAD - C, W2, D), np.float32)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_to_torch(x):
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)


def _assert_scores_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    row_max = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * row_max), \
        np.max(np.abs(got - want) / row_max)


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("n", [1, 2, 7, 1999, 2000])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.995, 1.0])
def test_quantile_matches_jnp_quantile(n, q):
    # XLA's CPU backend fuses low * (1 - w) into the add: rounding each
    # product on its own misses by an ulp in about a quarter of the rows
    # at q = 0.995 and n = 2000 (a candidate's W2 * D at V4)
    x = np.abs(rng.normal(size=(200, n))).astype(np.float32)
    got = T._quantile_rows(torch.from_numpy(x), q)
    want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_int4_round_trips_every_code():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)   # (3, 32)
    packed = T.pack_int4(codes)
    assert packed.shape == (3, 16) and packed.dtype == torch.uint8
    # lane 2i in the low nibble, lane 2i+1 in the high nibble
    assert int(packed[0, 0]) == (-8 & 0xF) | ((-7 & 0xF) << 4)
    assert torch.equal(T.unpack_int4(packed), codes)


@pytest.mark.parametrize("clip", [0.995, None])
@pytest.mark.parametrize("w2", [40, 37])
def test_pack_candidate_pool_int4(clip, w2):
    toks = CAND[:, :w2]
    pool, aux = T.pack_candidate_pool_int4(torch.from_numpy(toks),
                                           clip_quantile=clip)
    jpool, jaux = J.pack_candidate_pool_int4(jnp.asarray(toks),
                                             clip_quantile=clip)
    assert pool.shape == (C, 40, 32) and pool.dtype == torch.uint8
    assert aux.shape == (C, 2) and aux.dtype == torch.bfloat16
    np.testing.assert_array_equal(aux.view(torch.int16).numpy(),
                                  np.asarray(jaux).view(np.int16))
    codes = T.unpack_int4(pool)
    assert codes.shape == (C, 40, 64)
    np.testing.assert_array_equal(codes[..., :D].numpy(),
                                  np.asarray(jpool)[..., :D])
    assert torch.all(codes[..., D:] == 0)
    assert int(codes.abs().max()) == 7
    # padded token rows duplicate token 0
    assert torch.equal(codes[:, w2:], codes[:, :1].expand(-1, 40 - w2, -1))


def test_project_queries_int4():
    qi, qs = T.project_queries_int4(torch.from_numpy(Q), torch.from_numpy(W))
    jqi, jqs = J.project_queries_int4(jnp.asarray(Q), jnp.asarray(W))
    assert qi.shape == (NQ, M * W1, 64) and qi.dtype == torch.int8
    assert int(qi.abs().max()) == 7 and torch.all(qi[..., D:] == 0)
    diff = np.abs(qi.numpy()[..., :D].astype(np.int32)
                  - np.asarray(jqi)[..., :D].astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-4
    np.testing.assert_allclose(qs.numpy(), np.asarray(jqs), rtol=1e-6)


# ---------------------------------------------------------------- scoring
def test_int4_scorer_matches_jax_kernel_on_jax_operands():
    qw, qs = J.project_queries_int4(jnp.asarray(Q), jnp.asarray(W))
    pool, aux = J.pack_candidate_pool_int4(jnp.asarray(CAND_PAD))
    aux = J.mask_out_candidates_int4(aux, C)
    want = np.asarray(J.bilinear_maxsim_scores_int4(qw, qs, pool, aux,
                                                    interpret=True))
    # the JAX codes (Dp = 128, +-7 in int8) repacked two per byte
    packed = T.pack_int4(_t(pool))
    assert packed.shape == (C_PAD, 40, 64)
    got = T.bilinear_maxsim_scores_int4(_t(qw), _t(qs), packed,
                                        _bf16_to_torch(aux))
    assert got.shape == (NQ, C_PAD)
    _assert_scores_close(got.numpy()[:, :C], want[:, :C])
    np.testing.assert_array_equal(got.numpy()[:, C:], want[:, C:])


def test_int4_plain_is_the_int8_plain_on_unpacked_codes():
    q, cand, w = map(torch.from_numpy, (Q, CAND, W))
    qi, qs = T.project_queries_int4(q, w)
    pool, aux = T.pack_candidate_pool_int4(cand)
    assert torch.equal(
        T.bilinear_maxsim_scores_int4(qi, qs, pool, aux),
        T.bilinear_maxsim_scores_int8_plain(qi, qs, T.unpack_int4(pool), aux))


def test_int4_pipeline_approximates_the_f32_reference():
    q, cand, w = map(torch.from_numpy, (Q, CAND, W))
    ref = T.bilinear_maxsim_scores_reference(q, cand, w).numpy()
    int4 = T.bilinear_maxsim_scores_int4(*T.project_queries_int4(q, w),
                                         *T.pack_candidate_pool_int4(cand))
    # the +-7 grid: a few percent of the row's max |score|
    _assert_scores_close(int4.numpy(), ref, rtol=0.15)


# ------------------------------------------------------------------ masks
def test_masks_match_jax():
    rows = np.array([0, 7, 299, 150])
    toks = CAND[:, :37]
    pool = T.pack_candidate_pool(torch.from_numpy(toks))
    jpool = J.pack_candidate_pool(jnp.asarray(toks))
    got = T.mask_candidate_rows(pool.clone(), torch.from_numpy(rows))
    want = np.asarray(J.mask_candidate_rows(jpool, jnp.asarray(rows)))
    np.testing.assert_array_equal(got[..., -1].view(torch.int16).numpy(),
                                  want[..., -1].view(np.int16))
    for mask_rows, mask_out, jrows, jout in (
            (T.mask_candidate_rows_int8, T.mask_out_candidates_int8,
             J.mask_candidate_rows_int8, J.mask_out_candidates_int8),
            (T.mask_candidate_rows_int4, T.mask_out_candidates_int4,
             J.mask_candidate_rows_int4, J.mask_out_candidates_int4)):
        _, aux = T.pack_candidate_pool_int4(torch.from_numpy(toks))
        _, jaux = J.pack_candidate_pool_int4(jnp.asarray(toks))
        got = mask_out(mask_rows(aux, torch.from_numpy(rows)), 290)
        want = np.asarray(jout(jrows(jaux, jnp.asarray(rows)), 290))
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))


def test_masked_int4_candidates_score_the_mask():
    q, cand, w = map(torch.from_numpy, (Q, CAND, W))
    pool, aux = T.pack_candidate_pool_int4(cand)
    T.mask_candidate_rows_int4(aux, torch.tensor([3, 5]))
    s = T.bilinear_maxsim_scores_int4(*T.project_queries_int4(q, w), pool,
                                      aux)
    assert torch.all(s[:, [3, 5]] == aux[3, 1].float())
    assert torch.all(s[:, :3] > -1e29)


def test_int4_wrapper_rejects_bad_operands():
    q, cand, w = map(torch.from_numpy, (Q, CAND[:8], W))
    qi, qs = T.project_queries_int4(q, w)
    pool, aux = T.pack_candidate_pool_int4(cand)
    with pytest.raises(ValueError):           # unpacked width
        T.bilinear_maxsim_scores_int4(qi, qs, T.unpack_int4(pool), aux)
    with pytest.raises(ValueError):           # aux does not fit the pool
        T.bilinear_maxsim_scores_int4(qi, qs, pool, aux[:4])
    with pytest.raises(ValueError):           # no kernel on this device
        T.bilinear_maxsim_scores_int4(qi.to("meta"), qs.to("meta"),
                                      pool.to("meta"), aux.to("meta"))
    before = dict(T.LAUNCH_COUNTS)
    T.bilinear_maxsim_scores_int4(qi, qs, pool, aux)
    assert T.LAUNCH_COUNTS == before
