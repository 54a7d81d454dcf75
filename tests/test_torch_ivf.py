"""The port's IVF index against the JAX package's, with identical weights,
on small pools.

k-means draws from each package's own RNG (``jax.random`` there, a
``torch.Generator`` here), so the parity runs give the port JAX's
(centroids, assignment) by replacing the port's ``_kmeans``; everything
downstream (the bucket map with its capacity spill, routing, the probed
exact stage, the coarse stages) is then compared.  The JAX engines run
their Pallas kernels in interpret mode and are built once per module.

Tolerances: coarse vectors and token centroids rtol 1e-5 / atol 1e-6
(float32 means and Lloyd steps, summation order only); the bucket map
equal; scores within 1e-5 of the row's max |score| and indices equal
wherever neighbouring JAX scores are further apart than that, as in
``test_torch_engine.py``; probe-all against the port's own brute force
likewise (on the CPU the plain scorers' float32 sums may depend on the
slab's shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JM
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.serve import ivf as JIVF
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.serve import ivf as TIVF

JCFG = JM.MMSQAConfig(
    vocab_size=64, embed_dim=16, question_len=6, answer_len=6,
    sim_measures=2,
    blocks=(JM.ConvBlock(3, 3, 4, "ave", 2, 2),
            JM.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TM.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TM.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
RTOL = 1e-5
JPOOL = {"bf16": jnp.bfloat16, "int8": "int8"}
K_CLUSTERS, SEED, ITERS = 8, 1, 10


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    params, state = JM.mms_qa_init(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), params)
    return params


PARAMS_NP = _weights()
_rng = np.random.default_rng(31)
CAND_IDS = _rng.integers(0, 64, (240, 6)).astype(np.int32)
QUERY_IDS = _rng.integers(0, 64, (4, 6)).astype(np.int32)
Q = torch.from_numpy(QUERY_IDS)
DEAD = [7, 100, 201]


def _port(pool_dtype):
    params, _ = params_from_numpy(PARAMS_NP, jax.tree.map(
        np.asarray, JM.mms_qa_init(jax.random.PRNGKey(0), JCFG)[1]), "cpu")
    return QueryEngine(params, TCFG, pool_dtype=pool_dtype,
                       device="cpu").build_index(CAND_IDS)


def _jax(pool_dtype, dead=()):
    eng = JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                  interpret=True).build_index(CAND_IDS)
    if dead:
        eng.remove_candidates(list(dead))
    eng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                  coarse_tokens=3)
    return eng


def _port_ivf(monkeypatch, jeng, pool_dtype, dead=(), **kw):
    """The port's IVF over the same pool, clustered with JAX's k-means."""
    cent, assign = JIVF._kmeans(jeng.ivf._coarse_candidates(), K_CLUSTERS,
                                iters=ITERS, seed=SEED)
    np.testing.assert_array_equal(np.asarray(cent), jeng.ivf._cent_f32)
    monkeypatch.setattr(TIVF, "_kmeans", lambda vecs, k, iters, seed: (
        torch.from_numpy(np.array(cent)), torch.from_numpy(
            np.array(assign)).to(torch.int64)))
    eng = _port(pool_dtype)
    if dead:
        eng.remove_candidates(list(dead))
    eng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                  coarse_tokens=kw.get("coarse_tokens", 3))
    return eng


def _assert_topk_agrees(tv, ti, jv, ji):
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_array_equal(ti[~finite], ji[~finite])
    tol = RTOL * np.abs(np.where(finite, jv, 0)).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv - jv)[finite] <= np.broadcast_to(
        tol, jv.shape)[finite])
    gaps = np.abs(np.diff(np.where(finite, jv, -1e30), axis=1))
    sep = gaps > tol
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1) & finite
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


@pytest.fixture(scope="module")
def jax_engines():
    return {(pd, dead): _jax(pd, dead) for pd in ("bf16", "int8")
            for dead in ((), tuple(DEAD))}


# ------------------------------------------------------------------ build
def test_coarse_vectors_and_token_centroids_match_jax(jax_engines):
    jeng = jax_engines["bf16", ()]
    teng = _port("bf16")
    teng.build_ivf(n_clusters=K_CLUSTERS, coarse_tokens=3)
    np.testing.assert_allclose(teng.ivf._coarse_candidates().numpy(),
                               jeng.ivf._coarse_candidates(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(teng.ivf._token_centroids(3).numpy(),
                               jeng.ivf._token_centroids(3), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("dead", [(), tuple(DEAD)])
def test_bucket_map_equals_jax(monkeypatch, jax_engines, pool_dtype, dead):
    jeng = jax_engines[pool_dtype, dead]
    teng = _port_ivf(monkeypatch, jeng, pool_dtype, dead)
    iv = teng.ivf
    assert (iv.n_clusters, iv.bucket, iv.spilled) == (
        jeng.ivf.n_clusters, jeng.ivf.bucket, jeng.ivf.spilled)
    np.testing.assert_array_equal(iv.bucket_map.numpy(),
                                  np.asarray(jeng.ivf.bucket_map))
    assert not set(iv.bucket_map.flatten().tolist()) & set(dead)


def test_bucket_capacity_spill_matches_jax(monkeypatch, jax_engines):
    jeng = jax_engines["bf16", ()]
    cent, assign = JIVF._kmeans(jeng.ivf._coarse_candidates(), K_CLUSTERS,
                                iters=ITERS, seed=SEED)
    b = -(-len(CAND_IDS) // K_CLUSTERS) + 2     # below the largest cluster
    jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   bucket=b)
    monkeypatch.setattr(TIVF, "_kmeans", lambda vecs, k, iters, seed: (
        torch.from_numpy(np.array(cent)),
        torch.from_numpy(np.array(assign)).to(torch.int64)))
    teng = _port("bf16")
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, bucket=b)
    assert teng.ivf.spilled == jeng.ivf.spilled > 0
    np.testing.assert_array_equal(teng.ivf.bucket_map.numpy(),
                                  np.asarray(jeng.ivf.bucket_map))
    with pytest.raises(ValueError, match="cannot hold"):
        teng.build_ivf(n_clusters=K_CLUSTERS, bucket=2)
    jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   coarse_tokens=3)                  # restore the fixture


# ------------------------------------------------------------------ query
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("nprobe", [1, 3, K_CLUSTERS])
def test_ivf_query_matches_jax(monkeypatch, jax_engines, pool_dtype, nprobe):
    jeng = jax_engines[pool_dtype, ()]
    teng = _port_ivf(monkeypatch, jeng, pool_dtype)
    jv, ji = jeng.query_ivf(QUERY_IDS, k=10, nprobe=nprobe)
    tv, ti = teng.query_ivf(Q, k=10, nprobe=nprobe)
    _assert_topk_agrees(tv, ti, jv, ji)
    assert TIVF.ivf_recall(teng, Q, k=10, nprobe=nprobe) == pytest.approx(
        JIVF.ivf_recall(jeng, QUERY_IDS, k=10, nprobe=nprobe))


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_probe_all_equals_brute_force(pool_dtype):
    teng = _port(pool_dtype)
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=3)
    bv, bi = teng.query(Q, k=12)
    pv, pi = teng.query_ivf(Q, k=12, nprobe=K_CLUSTERS)
    _assert_topk_agrees(pv, pi, bv, bi)
    assert TIVF.ivf_recall(teng, Q, k=12, nprobe=K_CLUSTERS) == 1.0


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("coarse_tokens", [1, 3])
def test_query_coarse_matches_jax(monkeypatch, jax_engines, pool_dtype,
                                  coarse_tokens):
    jeng = jax_engines[pool_dtype, ()]
    if coarse_tokens == 1:
        jeng = _jax(pool_dtype)
        jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS)
    teng = _port_ivf(monkeypatch, jeng, pool_dtype,
                     coarse_tokens=coarse_tokens)
    assert (teng.ivf.coarse_pool is None) == (coarse_tokens == 1)
    for shortlist in (48, 240):
        jv, ji = jeng.ivf.query_coarse(QUERY_IDS, k=5, shortlist=shortlist)
        tv, ti = teng.ivf.query_coarse(Q, k=5, shortlist=shortlist)
        _assert_topk_agrees(tv, ti, jv, ji)
    assert TIVF.ivf_recall(teng, Q, k=5, method="coarse", shortlist=240) \
        == 1.0


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("approx_recall", [None, 0.5, 0.95])
def test_query_coarse_takes_approx_recall(monkeypatch, jax_engines,
                                          pool_dtype, approx_recall):
    """The port selects the shortlist exactly for every approx_recall: each
    result is JAX's exact selection (approx_recall=None)."""
    jeng = jax_engines[pool_dtype, ()]
    teng = _port_ivf(monkeypatch, jeng, pool_dtype)
    for shortlist in (48, 240):
        jv, ji = jeng.ivf.query_coarse(QUERY_IDS, k=5, shortlist=shortlist,
                                       approx_recall=None)
        tv, ti = teng.ivf.query_coarse(Q, k=5, shortlist=shortlist,
                                       approx_recall=approx_recall)
        _assert_topk_agrees(tv, ti, jv, ji)
        ev, ei = teng.ivf.query_coarse(Q, k=5, shortlist=shortlist)
        assert torch.equal(ti, ei) and torch.equal(tv, ev)


# ------------------------------------------------------------- tombstones
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_tombstones_never_returned(pool_dtype):
    teng = _port(pool_dtype)
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=2, coarse_tokens=3)
    _, top = teng.query_ivf(Q, k=4, nprobe=K_CLUSTERS)
    dead = set(top[:, 0].tolist())
    teng.remove_candidates(sorted(dead))               # after the build
    _, pi = teng.query_ivf(Q, k=4, nprobe=K_CLUSTERS)
    _, ci = teng.ivf.query_coarse(Q, k=4, shortlist=48)
    assert not (set(pi.flatten().tolist()) | set(ci.flatten().tolist())) \
        & dead
    # a k past the probed live rows: removed rows come back as -1, -inf
    v, i = teng.query_ivf(Q, k=len(CAND_IDS), nprobe=K_CLUSTERS)
    assert set(i[0].tolist()) == set(range(len(CAND_IDS))) - dead | {-1}
    assert torch.all(torch.isinf(v[i == -1]))
    # built after the removal: they never enter a bucket either
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=2)
    assert not set(teng.ivf.bucket_map.flatten().tolist()) & dead
    _, ci = teng.ivf.query_coarse(Q, k=4, shortlist=len(CAND_IDS))
    assert not set(ci.flatten().tolist()) & dead


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_rows_removed_after_the_build_never_fill_probe_slots(pool_dtype):
    # A fault of the reference (ROADMAP Queue 3): its probe stage scores a
    # row removed after the build with the mask (about -1e30), not -inf,
    # and clamps k to the pool size, not to the live rows, so with more
    # slots than live probed rows it returns the tombstones.  The port
    # returns index -1, score -inf in those slots.
    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                   interpret=True).build_index(CAND_IDS[:40])
    jeng.build_ivf(n_clusters=4, seed=0)
    teng = _port(pool_dtype).build_index(CAND_IDS[:40])
    teng.build_ivf(n_clusters=4, seed=0)
    dead = list(range(0, 40, 2))
    jeng.remove_candidates(dead)
    teng.remove_candidates(dead)
    jv, ji = jeng.query_ivf(QUERY_IDS[:1], k=40, nprobe=4)
    ji, jv = np.asarray(ji)[0], np.asarray(jv)[0]
    assert set(ji.tolist()) == set(range(40))            # tombstones back
    assert np.all(np.isfinite(jv)) and jv[ji % 2 == 0].max() < -1e29
    tv, ti = teng.query_ivf(Q[:1], k=40, nprobe=4)
    assert set(ti[0].tolist()) == set(range(1, 40, 2)) | {-1}
    assert torch.all(torch.isinf(tv[0][ti[0] == -1]))


def test_ivf_guards():
    params, _ = params_from_numpy(PARAMS_NP, jax.tree.map(
        np.asarray, JM.mms_qa_init(jax.random.PRNGKey(0), JCFG)[1]), "cpu")
    eng = QueryEngine(params, TCFG, pool_dtype="int4", device="cpu")
    with pytest.raises(ValueError):
        eng.build_ivf()                         # nothing built
    eng.build_index(CAND_IDS)
    with pytest.raises(ValueError, match="int4"):
        eng.build_ivf(n_clusters=4)
    with pytest.raises(RuntimeError):
        eng.query_ivf(Q)
    tok = QueryEngine(params, TCFG, device="cpu").build_index_from_tokens(
        np.zeros((8, 6, 16), np.float32))
    with pytest.raises(ValueError):
        tok.build_ivf(n_clusters=2)
    bf = QueryEngine(params, TCFG, device="cpu").build_index(CAND_IDS)
    with pytest.raises(ValueError):
        bf.build_ivf(coarse_tokens=0)
    bf.build_ivf(n_clusters=4, seed=0)
    bf.add_candidates(CAND_IDS[:3])             # the IVF no longer covers it
    assert bf.ivf is None


def test_kmeans_finds_separated_blobs():
    g = torch.Generator().manual_seed(0)
    centers = torch.tensor([[10.0, 0.0], [-10.0, 0.0], [0.0, 10.0]])
    pts = torch.cat([c + torch.randn((50, 2), generator=g) * 0.1
                     for c in centers])
    for init_sample in (150, 40):               # all points, a subsample
        cent, assign = TIVF._kmeans(pts, 3, seed=4, init_sample=init_sample,
                                    chunk=32)
        for b in range(3):
            blob = assign[b * 50:(b + 1) * 50]
            assert torch.all(blob == blob[0])
            assert torch.allclose(cent[blob[0]], centers[b], atol=0.1)
        again = TIVF._kmeans(pts, 3, seed=4, init_sample=init_sample,
                             chunk=32)
        assert torch.equal(again[0], cent) and torch.equal(again[1], assign)


# ------------------------------------------------------------ persistence
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_save_load_keeps_the_ivf(pool_dtype, tmp_path):
    teng = _port(pool_dtype)
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=5, coarse_tokens=3)
    teng.remove_candidates([1, 2])
    path = str(tmp_path / "ivf.npz")
    teng.save_index(path)
    other = _port(pool_dtype)
    other.load_index(path)
    iv, ov = teng.ivf, other.ivf
    assert (ov.n_clusters, ov.bucket, ov.spilled, ov.coarse_tokens) == (
        iv.n_clusters, iv.bucket, iv.spilled, iv.coarse_tokens)
    for name in ("bucket_map", "centroids", "coarse", "coarse_pool"):
        assert torch.equal(getattr(ov, name), getattr(iv, name)), name
    for a, b in zip(other.query_ivf(Q, k=6, nprobe=3),
                    teng.query_ivf(Q, k=6, nprobe=3)):
        assert torch.equal(a, b)
    for a, b in zip(other.ivf.query_coarse(Q, k=6, shortlist=40),
                    teng.ivf.query_coarse(Q, k=6, shortlist=40)):
        assert torch.equal(a, b)
