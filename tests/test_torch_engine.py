"""The port's QueryEngine against the JAX package's, with identical
weights, on small pools.

The JAX engine runs its Pallas kernels in interpret mode; the port's runs
its plain scorers (CPU tensors).  Scores must agree to 1e-5 of the row's
max |score| (the same packers' rounding rules and the same operands up to
float32 summation order; a rare +-1 int8 code may differ, which moves a
score by far less).  Top-k indices must agree wherever the JAX gap between
neighbouring ranks exceeds that tolerance.  Rerank probabilities: atol
1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JM
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.serve import topk_merge as j_topk_merge
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as TK
from mms_answer_selection_tpu_torch.serve import (
    QueryEngine,
    topk,
    topk_merge,
)

JCFG = JM.MMSQAConfig(
    vocab_size=64, embed_dim=16, question_len=6, answer_len=6,
    sim_measures=2,
    blocks=(JM.ConvBlock(3, 3, 4, "ave", 2, 2),
            JM.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TM.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TM.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
N_CAND = 200
RTOL = 1e-5
JPOOL = {"bf16": jnp.bfloat16, "int8": "int8"}


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    params, state = JM.mms_qa_init(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), params)
    state = jax.tree.map(lambda x: np.abs(rng.normal(size=x.shape)).astype(
        np.float32) + 0.3, state)
    return params, state


PARAMS_NP, STATE_NP = _weights()
_rng = np.random.default_rng(11)
CAND_IDS = _rng.integers(0, 64, (N_CAND, 6)).astype(np.int32)
QUERY_IDS = _rng.integers(0, 64, (5, 6)).astype(np.int32)


def _engines(pool_dtype, cand_ids=CAND_IDS):
    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                   interpret=True)
    jeng.build_index(cand_ids)
    params, state = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    teng = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu")
    teng.build_index(cand_ids)
    return jeng, teng, state


def _assert_topk_agrees(tv, ti, jv, ji):
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    tol = RTOL * np.abs(jv).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv - jv) <= tol), np.max(np.abs(tv - jv) / tol)
    # a rank is pinned when the JAX scores on both sides of it are
    # separated by more than the tolerance
    gaps = np.diff(jv, axis=1)
    sep = np.abs(gaps) > tol
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1)
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_query_matches_jax_engine(pool_dtype):
    jeng, teng, _ = _engines(pool_dtype)
    jv, ji = jeng.query(QUERY_IDS, k=10)
    tv, ti = teng.query(torch.from_numpy(QUERY_IDS), k=10)
    assert tv.shape == (5, 10) and ti.dtype == torch.int64
    _assert_topk_agrees(tv, ti, jv, ji)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_query_rerank_matches_jax_engine(pool_dtype):
    jeng, teng, state = _engines(pool_dtype)
    of = np.random.default_rng(3).normal(size=(5, 2)).astype(np.float32)
    for overlap in (None, of):
        jv, ji = jeng.query_rerank(STATE_NP, QUERY_IDS, k=4, shortlist=12,
                                   overlap_feat=overlap)
        tv, ti = teng.query_rerank(
            state, torch.from_numpy(QUERY_IDS), k=4, shortlist=12,
            overlap_feat=None if overlap is None else torch.from_numpy(of))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_score_pairs_matches_jax_engine():
    jeng, teng, state = _engines("bf16")
    want = jeng.score_pairs(STATE_NP, QUERY_IDS, CAND_IDS[:5])
    got = teng.score_pairs(state, torch.from_numpy(QUERY_IDS),
                           torch.from_numpy(CAND_IDS[:5]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_duplicate_candidates_tie_lower_index_first(pool_dtype):
    # rows 3, 40, 41 and 150 are one candidate: identical scores, and every
    # tied pair must come back lower index first, as lax.top_k orders them
    cand = CAND_IDS.copy()
    cand[[40, 41, 150]] = cand[3]
    jeng, teng, _ = _engines(pool_dtype, cand)
    q = np.repeat(cand[3:4], 2, axis=0)      # the duplicate scores highest
    jv, ji = jeng.query(q, k=N_CAND)
    tv, ti = teng.query(torch.from_numpy(q), k=N_CAND)
    ti = ti.numpy()
    pos = {int(i): r for r, i in enumerate(ti[0])}
    assert pos[3] < pos[40] < pos[41] < pos[150]
    assert pos[150] == pos[3] + 3            # adjacent: they tie exactly
    np.testing.assert_array_equal(ti[0, pos[3]:pos[3] + 4],
                                  np.asarray(ji)[0, pos[3]:pos[3] + 4])


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_k_larger_than_the_pool_is_clamped(pool_dtype):
    jeng, teng, state = _engines(pool_dtype, CAND_IDS[:5])
    tv, ti = teng.query(torch.from_numpy(QUERY_IDS), k=10)
    jv, ji = jeng.query(QUERY_IDS, k=10)
    assert tv.shape == (5, 5) == np.asarray(jv).shape
    assert sorted(ti[0].tolist()) == list(range(5))
    rv, ri = teng.query_rerank(state, torch.from_numpy(QUERY_IDS), k=10,
                               shortlist=50)
    jrv, jri = jeng.query_rerank(STATE_NP, QUERY_IDS, k=10, shortlist=50)
    assert rv.shape == (5, 5) == np.asarray(jrv).shape
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))


def test_build_index_from_tokens_matches_reference():
    rng = np.random.default_rng(5)
    toks = rng.normal(size=(70, 9, 16)).astype(np.float32)
    qt = rng.normal(size=(3, 6, 16)).astype(np.float32)
    params, _ = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    ref = TK.bilinear_maxsim_scores_reference(
        torch.from_numpy(qt), torch.from_numpy(toks), params["sim"]["w"])
    for pool_dtype, rtol in (("bf16", 1e-2), ("int8", 5e-2)):
        eng = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu")
        eng.build_index_from_tokens(toks)
        vals, idx = eng.query(torch.from_numpy(qt), k=5)
        want = torch.gather(ref, 1, idx)
        assert torch.all((vals - want).abs()
                         <= rtol * ref.abs().amax(1, keepdim=True))
        with pytest.raises(ValueError):
            eng.query_rerank({}, torch.zeros((1, 6), dtype=torch.int64))


def test_engine_guards():
    params, _ = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    eng = QueryEngine(params, TCFG, device="cpu")
    with pytest.raises(RuntimeError):
        eng.query(torch.zeros((1, 6), dtype=torch.int64))
    with pytest.raises(ValueError):
        QueryEngine(params, TCFG, pool_dtype="fp8", device="cpu")
    with pytest.raises(ValueError):
        QueryEngine(params, dataclasses.replace(TCFG, sim_mode=0),
                    device="cpu")


def test_topk_orders_ties_by_index():
    s = torch.tensor([[1.0, 3.0, -0.0, 3.0, 0.0, -np.inf, 3.0, -2.0]])
    vals, idx = topk(s, 8)
    assert idx.tolist() == [[1, 3, 6, 0, 4, 2, 7, 5]]
    jv, ji = jax.lax.top_k(jnp.asarray(s.numpy()), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_topk_merge_matches_jax():
    rng = np.random.default_rng(8)
    vals = np.round(rng.normal(size=(3, 4, 5)), 1).astype(np.float32)
    idxs = rng.integers(0, 1000, (3, 4, 5)).astype(np.int32)
    jv, ji = j_topk_merge(jnp.asarray(vals), jnp.asarray(idxs), 6)
    tv, ti = topk_merge(torch.from_numpy(vals), torch.from_numpy(idxs), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
