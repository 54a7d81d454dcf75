"""V4_WIDE's widths (GloVe-300d: D = 300, M = 4 measures) in the port's
QueryEngine on CPU against the JAX package's, with identical weights, on a
small pool and short sentences; the JAX side runs its Pallas scorers in
interpret mode, as ``tests/test_trainer.py``'s D = 300 kernel test does.

The two packers pad D differently (the reference to 384 lanes, the port to
Dp 304 bf16 / 320 int8, which its CUDA kernels slice into 128-byte
spans); the zero lanes change no dot product.  Scores must agree to
RTOL of the row's max |score|: int8 1e-5 (the same rounding rules and
operands up to float32 summation order); bf16 1e-4, because a projected
query lane, a float32 sum of 300 products taken in another order by each
framework, can round to the neighbouring bf16 value (2^-8 of it) before
it is scored.  Top-k indices must agree wherever the JAX gap between
neighbouring ranks exceeds that tolerance.  Rerank probabilities (float32
throughout): atol 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JM
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as TK
from mms_answer_selection_tpu_torch.serve import QueryEngine

# V4_WIDE's embedding width and measures, its conv stack cut to fit six
# tokens a sentence
JCFG = JM.MMSQAConfig(
    vocab_size=64, embed_dim=300, question_len=6, answer_len=6,
    sim_measures=4,
    blocks=(JM.ConvBlock(3, 3, 4, "ave", 2, 2),
            JM.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TM.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TM.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
N_CAND = 200
RTOL = {"bf16": 1e-4, "int8": 1e-5}


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    params, state = JM.mms_qa_init(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.normal(
        size=x.shape).astype(np.float32), params)
    state = jax.tree.map(lambda x: np.abs(rng.normal(size=x.shape)).astype(
        np.float32) + 0.3, state)
    return params, state


PARAMS_NP, STATE_NP = _weights()
_rng = np.random.default_rng(12)
CAND_IDS = _rng.integers(0, 64, (N_CAND, 6)).astype(np.int32)
QUERY_IDS = _rng.integers(0, 64, (5, 6)).astype(np.int32)


def _engines(pool_dtype):
    import jax.numpy as jnp

    jdtype = jnp.bfloat16 if pool_dtype == "bf16" else "int8"
    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=jdtype, interpret=True)
    jeng.build_index(CAND_IDS)
    params, state = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    teng = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu")
    teng.build_index(CAND_IDS)
    return jeng, teng, state


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_wide_query_matches_jax_engine(pool_dtype):
    jeng, teng, _ = _engines(pool_dtype)
    assert teng.pool.shape[-1] == (304 if pool_dtype == "bf16" else 320)
    jv, ji = (np.asarray(x) for x in jeng.query(QUERY_IDS, k=10))
    tv, ti = (x.numpy() for x in teng.query(torch.from_numpy(QUERY_IDS),
                                            k=10))
    tol = RTOL[pool_dtype] * np.abs(jv).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv - jv) <= tol), np.max(np.abs(tv - jv) / tol)
    sep = np.abs(np.diff(jv, axis=1)) > tol
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1)
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_wide_query_rerank_matches_jax_engine(pool_dtype):
    jeng, teng, state = _engines(pool_dtype)
    jv, ji = jeng.query_rerank(STATE_NP, QUERY_IDS, k=4, shortlist=12)
    tv, ti = teng.query_rerank(state, torch.from_numpy(QUERY_IDS), k=4,
                               shortlist=12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_wide_k_sliced_plans_cover_the_engine():
    """The card's plan for this engine's pools: K-sliced (rows past 256
    bytes), every tile and group covered once."""
    _, teng, _ = _engines("bf16")
    r = TCFG.sim_measures * TCFG.question_len
    dp = teng.pool.shape[-1]
    for nq in (1, 5, 256):
        for dtype, d in (("bf16", dp), ("int8", 320), ("int4", 320)):
            geo = TK.maxsim_geometry(nq, r, N_CAND, 8, d, dtype)
            assert geo.k_sliced
            assert geo.n_groups * geo.g >= nq > (geo.n_groups - 1) * geo.g
            assert geo.n_tiles * geo.n_c >= N_CAND
