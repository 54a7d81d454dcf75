"""The port's QueryEngine at pool scale against the JAX package's, with
identical weights, on small pools: the int4 mode, chunked scoring with the
incremental top-k merge, the clamps, and the index lifecycle (reserve,
add, remove, n_live, compact, save/load).

The JAX engines run their Pallas kernels in interpret mode and are built
once per module (fixtures); the port runs its plain scorers (CPU tensors).
Tolerances, as in ``test_torch_engine.py``: scores within 1e-5 of the
row's max |score| (the same packers' rounding and the same operands up to
float32 summation order), indices equal wherever the JAX gap between
neighbouring ranks exceeds that; rerank probabilities atol 1e-5.  Within
the port, packing chunk by chunk gives the one-shot packing's bits, and
chunked scoring is held to unchunked scoring with the same tolerance: on
the CPU the plain scorers' float32 matmul and row sum may order a sum by
the slab's shape (the CUDA kernels give equal bits, checked on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JM
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as TK
from mms_answer_selection_tpu_torch.serve import QueryEngine

JCFG = JM.MMSQAConfig(
    vocab_size=64, embed_dim=16, question_len=6, answer_len=6,
    sim_measures=2,
    blocks=(JM.ConvBlock(3, 3, 4, "ave", 2, 2),
            JM.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TM.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TM.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
RTOL = 1e-5
JPOOL = {"bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}
DTYPES = ["bf16", "int8", "int4"]
CHUNK = 128           # the JAX bf16 and int4 engines' candidate block


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    params, state = JM.mms_qa_init(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), params)
    state = jax.tree.map(lambda x: np.abs(rng.normal(size=x.shape)).astype(
        np.float32) + 0.3, state)
    return params, state


PARAMS_NP, STATE_NP = _weights()
_rng = np.random.default_rng(23)
CAND_IDS = _rng.integers(0, 64, (300, 6)).astype(np.int32)
QUERY_IDS = _rng.integers(0, 64, (5, 6)).astype(np.int32)
Q = torch.from_numpy(QUERY_IDS)


def _port(pool_dtype, cand=CAND_IDS, reserve=0, **kw):
    params, state = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    eng = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu",
                      **kw)
    return eng.build_index(cand, reserve=reserve), state


def _jax(pool_dtype, cand=CAND_IDS, reserve=0, **kw):
    return JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                   interpret=True, **kw).build_index(cand, reserve=reserve)


def _assert_topk_agrees(tv, ti, jv, ji):
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    tol = RTOL * np.abs(jv).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv - jv) <= tol), np.max(np.abs(tv - jv) / tol)
    gaps = np.diff(jv, axis=1)
    sep = np.abs(gaps) > tol
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1)
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


@pytest.fixture(scope="module")
def jax_int4():
    return _jax("int4", CAND_IDS[:200])


@pytest.fixture(scope="module")
def jax_chunked():
    """JAX engines over 300 candidates in chunks of 128 (padded to 384)."""
    return {pd: _jax(pd, chunk_size=CHUNK) for pd in ("bf16", "int4")}


# -------------------------------------------------------------- int4 mode
def test_int4_query_matches_jax_engine(jax_int4):
    teng, _ = _port("int4", CAND_IDS[:200])
    assert teng.pool.dtype == torch.uint8 and teng.pool.shape == (200, 8, 16)
    jv, ji = jax_int4.query(QUERY_IDS, k=10)
    tv, ti = teng.query(Q, k=10)
    _assert_topk_agrees(tv, ti, jv, ji)


def test_int4_query_rerank_matches_jax_engine(jax_int4):
    teng, state = _port("int4", CAND_IDS[:200])
    jv, ji = jax_int4.query_rerank(STATE_NP, QUERY_IDS, k=4, shortlist=12)
    tv, ti = teng.query_rerank(state, Q, k=4, shortlist=12)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# --------------------------------------------------------------- chunking
@pytest.mark.parametrize("pool_dtype", ["bf16", "int4"])
def test_chunked_query_matches_jax_chunked_engine(pool_dtype, jax_chunked):
    jeng = jax_chunked[pool_dtype]
    assert jeng.chunks is not None
    teng, _ = _port(pool_dtype, chunk_size=CHUNK)
    for k in (10, 200):        # 200 > chunk: both clamp to 128
        jv, ji = jeng.query(QUERY_IDS, k=k)
        tv, ti = teng.query(Q, k=k)
        assert tv.shape == (5, min(k, CHUNK))
        _assert_topk_agrees(tv, ti, jv, ji)


def test_chunked_rerank_clamps_shortlist_like_jax(jax_chunked):
    teng, state = _port("int4", chunk_size=CHUNK)
    jv, ji = jax_chunked["int4"].query_rerank(STATE_NP, QUERY_IDS, k=150,
                                             shortlist=200)
    tv, ti = teng.query_rerank(state, Q, k=150, shortlist=200)
    assert tv.shape == (5, CHUNK) == np.asarray(jv).shape
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_chunked_equals_unchunked(pool_dtype):
    flat, _ = _port(pool_dtype)
    chunked, _ = _port(pool_dtype, chunk_size=64)
    # packing chunk by chunk gives the one-shot packing's bits
    assert torch.equal(chunked.pool, flat.pool)
    assert (flat.aux is None) or torch.equal(chunked.aux, flat.aux)
    fv, fi = flat.query(Q, k=64)
    cv, ci = chunked.query(Q, k=64)
    _assert_topk_agrees(cv, ci, fv, fi)


@pytest.mark.parametrize("pool_dtype", ["int8", "int4"])
def test_chunk_merge_keeps_the_lower_index_first_on_ties(pool_dtype):
    # query 0's best candidate copied into two later chunks of 64: the
    # three tie for first place and must come back in index order
    flat, _ = _port(pool_dtype)
    top = int(flat.query(Q[:1], k=1)[1][0, 0])
    rows = sorted({top, (top + 100) % 300, (top + 200) % 300})
    cand = CAND_IDS.copy()
    cand[rows] = CAND_IDS[top]
    chunked, _ = _port(pool_dtype, cand, chunk_size=64)
    vals, idx = chunked.query(Q[:1], k=5)
    assert idx[0, :3].tolist() == rows
    assert vals[0, 0] == vals[0, 2] > vals[0, 3]


@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_k_is_clamped_to_live_rows_and_chunk(pool_dtype):
    teng, state = _port(pool_dtype, CAND_IDS[:40], chunk_size=16)
    teng.remove_candidates([0, 1, 2])
    v, i = teng.query(Q, k=100)
    assert v.shape == (5, 16)               # chunk_size
    teng.chunk_size = 1000
    v, i = teng.query(Q, k=100)
    assert v.shape == (5, 37)               # n_live
    assert not set(i.flatten().tolist()) & {0, 1, 2}
    rv, ri = teng.query_rerank(state, Q, k=100, shortlist=100)
    assert rv.shape == (5, 37) and not set(ri.flatten().tolist()) & {0, 1, 2}


# -------------------------------------------------------------- lifecycle
@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_lifecycle_matches_jax_engine(pool_dtype):
    jeng = _jax(pool_dtype, CAND_IDS[:150], reserve=20)
    teng, _ = _port(pool_dtype, CAND_IDS[:150], reserve=20)
    assert teng.pool.shape[0] == 170 and teng.pool_size == 150
    # 30 rows: 20 into the reserve, then the pool grows
    new = teng.add_candidates(CAND_IDS[150:180])
    np.testing.assert_array_equal(new.numpy(),
                                  jeng.add_candidates(CAND_IDS[150:180]))
    assert teng.pool.shape[0] == 180
    _assert_topk_agrees(*teng.query(Q, k=10), *jeng.query(QUERY_IDS, k=10))
    # tombstones: each query's best hit and a few more
    _, top = jeng.query(QUERY_IDS, k=1)
    dead = sorted(set(np.asarray(top).ravel().tolist()) | {3, 151, 179})
    teng.remove_candidates(torch.tensor(dead))
    jeng.remove_candidates(dead)
    assert teng.n_live == jeng.n_live == 180 - len(dead)
    np.testing.assert_array_equal(teng.deleted.numpy(), jeng.deleted)
    tv, ti = teng.query(Q, k=10)
    _assert_topk_agrees(tv, ti, *jeng.query(QUERY_IDS, k=10))
    assert not set(ti.flatten().tolist()) & set(dead)
    # a k past the live rows returns every live row, never a tombstone
    tv, ti = teng.query(Q, k=500)
    assert tv.shape == (5, teng.n_live) == np.asarray(
        jeng.query(QUERY_IDS, k=500)[0]).shape
    assert set(ti[0].tolist()) == set(range(180)) - set(dead)
    # an add after a remove keeps the tombstones
    teng.add_candidates(CAND_IDS[180:185])
    jeng.add_candidates(CAND_IDS[180:185])
    _assert_topk_agrees(*teng.query(Q, k=10), *jeng.query(QUERY_IDS, k=10))
    mapping = teng.compact()
    np.testing.assert_array_equal(mapping.numpy(), jeng.compact())
    assert teng.pool_size == teng.n_live == 185 - len(dead)
    assert teng.deleted.numel() == 0
    _assert_topk_agrees(*teng.query(Q, k=10), *jeng.query(QUERY_IDS, k=10))


@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_add_packs_only_new_rows_and_equals_a_rebuild(pool_dtype):
    teng, _ = _port(pool_dtype, CAND_IDS[:100], chunk_size=32)
    before = teng.pool[:100].clone()
    teng.add_candidates(CAND_IDS[100:170])
    full, _ = _port(pool_dtype, CAND_IDS[:170])
    assert torch.equal(teng.pool[:100], before)
    assert torch.equal(teng.pool, full.pool)
    assert (full.aux is None) or torch.equal(teng.aux, full.aux)
    assert torch.equal(teng.cand_token_ids, full.cand_token_ids)


@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_compact_map_and_pool(pool_dtype):
    teng, _ = _port(pool_dtype, CAND_IDS[:50], reserve=7)
    teng.remove_candidates([0, 10, 49, 10])
    mapping = teng.compact()
    keep = [i for i in range(50) if i not in (0, 10, 49)]
    assert mapping[keep].tolist() == list(range(47))
    assert mapping[[0, 10, 49]].tolist() == [-1, -1, -1]
    fresh, _ = _port(pool_dtype, CAND_IDS[keep])
    assert torch.equal(teng.pool, fresh.pool)
    assert torch.equal(teng.cand_token_ids, fresh.cand_token_ids)


def test_lifecycle_guards():
    params, _ = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    eng = QueryEngine(params, TCFG, pool_dtype="int4", device="cpu")
    with pytest.raises(ValueError):
        eng.add_candidates(CAND_IDS[:2])
    eng.remove_candidates([])                   # nothing to do
    with pytest.raises(ValueError):
        eng.remove_candidates([1])
    eng.build_index(CAND_IDS[:10])
    with pytest.raises(ValueError):
        eng.remove_candidates([10])
    with pytest.raises(ValueError):
        eng.add_candidates(CAND_IDS[:2, :4])
    eng.remove_candidates(range(10))
    with pytest.raises(ValueError):
        eng.compact()
    with pytest.raises(ValueError):
        eng.query_rerank({}, Q)
    assert eng.query(Q, k=5)[0].shape == (5, 0)
    tokens = QueryEngine(params, TCFG, device="cpu").build_index_from_tokens(
        np.zeros((4, 6, 16), np.float32))
    for call in (lambda: tokens.add_candidates(CAND_IDS[:1]), tokens.compact):
        with pytest.raises(ValueError):
            call()


# ------------------------------------------------------------ persistence
@pytest.mark.parametrize("pool_dtype", DTYPES)
def test_save_load_round_trip(pool_dtype, tmp_path):
    teng, _ = _port(pool_dtype, chunk_size=CHUNK)
    teng.add_candidates(CAND_IDS[:10])
    teng.remove_candidates([4, 250])
    path = str(tmp_path / "index.npz")
    teng.save_index(path)
    other, _ = _port(pool_dtype, CAND_IDS[:3])
    other.load_index(path)
    assert other.pool_size == 310 and other.n_live == 308
    assert other.chunk_size == CHUNK
    assert torch.equal(other.deleted, teng.deleted)
    assert torch.equal(other.pool, teng.pool[:310])
    for a, b in zip(other.query(Q, k=20), teng.query(Q, k=20)):
        assert torch.equal(a, b)
    # a file of another dtype is refused
    wrong, _ = _port("int8" if pool_dtype != "int8" else "bf16",
                     CAND_IDS[:3])
    with pytest.raises(ValueError, match="layout"):
        wrong.load_index(path)


def test_load_refuses_other_weights(tmp_path):
    teng, _ = _port("int8", CAND_IDS[:20])
    path = str(tmp_path / "index.npz")
    teng.save_index(path)
    params, _ = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    params["sim"]["w"] = params["sim"]["w"] + 1.0
    other = QueryEngine(params, TCFG, pool_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        other.load_index(path)


def test_fingerprint_equals_jax(jax_int4):
    teng, _ = _port("int4", CAND_IDS[:3])
    assert teng._params_fingerprint() == jax_int4._params_fingerprint()


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_jax_written_index_is_refused(pool_dtype, tmp_path):
    path = str(tmp_path / "jax_index.npz")
    _jax(pool_dtype, CAND_IDS[:40]).save_index(path)
    teng, _ = _port(pool_dtype, CAND_IDS[:3])
    with pytest.raises(ValueError, match="layout"):
        teng.load_index(path)
    assert teng.pool_size == 3                 # left as it was


def test_build_index_from_host_tokens_in_chunks():
    rng = np.random.default_rng(5)
    toks = rng.normal(size=(70, 9, 16)).astype(np.float32)
    params, _ = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    for pool_dtype in DTYPES:
        one = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu")
        many = QueryEngine(params, TCFG, pool_dtype=pool_dtype, device="cpu",
                           chunk_size=16)
        one.build_index_from_tokens(toks)
        many.build_index_from_tokens(toks)
        assert torch.equal(one.pool, many.pool)
        qt = torch.from_numpy(toks[:3, :6])
        _assert_topk_agrees(*many.query(qt, k=5), *one.query(qt, k=5))
        want = TK.bilinear_maxsim_scores_reference(
            qt, torch.from_numpy(toks), params["sim"]["w"])
        vals, idx = many.query(qt, k=5)
        rtol = {"bf16": 1e-2, "int8": 5e-2, "int4": 0.2}[pool_dtype]
        assert torch.all((vals - torch.gather(want, 1, idx)).abs()
                         <= rtol * want.abs().amax(1, keepdim=True))
