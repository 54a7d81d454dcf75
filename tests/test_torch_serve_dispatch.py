"""The port's one-dispatch serving and eval (``utils/graphs.py``) against
the JAX package's jitted programs, on the CPU.

On the card ``query``'s chunk scan, ``query_rerank``, ``query_ivf``,
``query_coarse`` and the trainer's eval step are each one CUDA graph
replay; on the CPU the same bodies run eagerly through the same static
buffers and keys, so these tests hold the bodies, the keying and the
invalidation:

* the four serving paths with ``scan_chunks`` True and False, against the
  JAX engine built with the same flag (a pool in three chunks, the
  second a copy of the first: tied scores, lower index first; ``k`` past
  the live rows);
* True against False within the port: the same tensors, bit for bit;
* after an add past the reserve, a removal, ``compact``, ``save_index`` /
  ``load_index`` and ``build_ivf`` the results equal JAX's after the same
  operations, and the engine keeps no graph of an older version;
* the eval step's dicts (``map``, ``mrr``, ``auc``, ``prob``) against the
  JAX trainer's jitted ``eval_step`` on both sides of the sorted-metrics
  threshold, one key per split shape;
* ``QAServer(pad_buckets=)`` True and False against the JAX server on the
  same requests: the same replies and the same padded row counts.

The JAX engines run their Pallas kernels in interpret mode; the port runs
its plain scorers.  Tolerances, as in ``test_torch_engine.py`` and
``test_torch_ivf.py``: scores within 1e-5 of the row's max |score|,
indices equal wherever neighbouring JAX scores are further apart; rerank
probabilities atol 1e-5; the eval's metrics rtol 1e-5, atol 1e-6, its
probabilities ``test_torch_training.py``'s STEP_TOL (float32 sums of the
convolutions and the MLP in another order, over a few thousand pairs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.serve import QAServer as JServer
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.serve import ivf as JIVF
from mms_answer_selection_tpu.training import Trainer as JTrainer
from mms_answer_selection_tpu.training import TrainerConfig as JTrainerConfig
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.serve import QAServer, QueryEngine
from mms_answer_selection_tpu_torch.serve import ivf as TIVF
from mms_answer_selection_tpu_torch.training import Trainer
from mms_answer_selection_tpu_torch.training.trainer import (
    _SORTED_METRICS_THRESHOLD,
)
from tests.test_torch_engine_scale import (
    CHUNK,
    JCFG,
    TCFG,
    _assert_topk_agrees,
    _weights,
)
from tests.test_torch_ivf import _assert_topk_agrees as _assert_ivf_agrees
from tests.test_torch_training import (
    STEP_TOL,
    _small_cfg,
    _t_trainer_cfg,
    _tcfg,
)

PARAMS_NP, STATE_NP = _weights(seed=4)
_rng = np.random.default_rng(41)
PLAIN_IDS = _rng.integers(0, 64, (300, 6)).astype(np.int32)
# ties across chunks of 128: the second copies the first (on the CPU only
# slabs of one shape give a copy the same float32 score); the paths whose
# top-k boundary a tie would decide run on PLAIN_IDS
CAND_IDS = PLAIN_IDS.copy()
CAND_IDS[128:256] = CAND_IDS[:128]
QUERY_IDS = _rng.integers(0, 64, (5, 6)).astype(np.int32)
OVERLAP = _rng.random((5, 2)).astype(np.float32)
Q = torch.from_numpy(QUERY_IDS)
JPOOL = {"bf16": jnp.bfloat16, "int8": "int8", "int4": "int4"}
K_CLUSTERS, SEED, ITERS = 6, 1, 8


def _port(pool_dtype, scan, cand=CAND_IDS, reserve=0):
    params, state = params_from_numpy(PARAMS_NP, STATE_NP, "cpu")
    eng = QueryEngine(params, TCFG, pool_dtype=pool_dtype, chunk_size=CHUNK,
                      scan_chunks=scan, device="cpu")
    return eng.build_index(cand, reserve=reserve), state


def _jax(pool_dtype, scan, cand=CAND_IDS, reserve=0):
    """JAX's engine: chunked as the port's (the int8 Pallas kernel's
    candidate block is 1,024, past this pool, so int8 is unchunked: the
    chunk merge gives the unchunked order)."""
    kw = {} if pool_dtype == "int8" else {"chunk_size": CHUNK}
    return JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                   interpret=True, scan_chunks=scan,
                   **kw).build_index(cand, reserve=reserve)


def _pinned_kmeans(monkeypatch, jeng):
    """The port's k-means replaced by JAX's result on ``jeng``'s pool."""
    cent, assign = JIVF._kmeans(jeng.ivf._coarse_candidates(), K_CLUSTERS,
                                iters=ITERS, seed=SEED)
    monkeypatch.setattr(TIVF, "_kmeans", lambda vecs, k, iters, seed: (
        torch.from_numpy(np.array(cent)),
        torch.from_numpy(np.array(assign)).to(torch.int64)))


def _ivf_pair(monkeypatch, pool_dtype, scan):
    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=JPOOL[pool_dtype],
                   interpret=True).build_index(PLAIN_IDS)
    jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   coarse_tokens=3)
    _pinned_kmeans(monkeypatch, jeng)
    teng, _ = _port(pool_dtype, scan, PLAIN_IDS)
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   coarse_tokens=3)
    return jeng, teng


def _assert_rerank_agrees(tv, ti, jv, ji):
    """Probabilities atol 1e-5; indices equal wherever JAX's neighbouring
    probabilities are further apart (a copy's pair may round apart in the
    last bit on the CPU, so ties are not pinned)."""
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    sep = np.abs(np.diff(jv, axis=1)) > 1e-5
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1)
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


def _assert_ties_lower_first(idx):
    """Copies of one candidate (equal scores) come lower index first."""
    for row in np.asarray(idx):
        row = row[row >= 0]
        for p in range(len(row)):
            for q in range(p + 1, len(row)):
                if (CAND_IDS[row[p]] == CAND_IDS[row[q]]).all():
                    assert row[p] < row[q], row


# --------------------------------------------------------------- the paths
@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_query_matches_jax(pool_dtype, scan):
    teng, _ = _port(pool_dtype, scan)
    jeng = _jax(pool_dtype, scan)
    # past the chunk: clamped to it (JAX's int8 engine is unchunked)
    for k in (10, 128 if pool_dtype == "int8" else 400):
        tv, ti = teng.query(Q, k=k)
        _assert_topk_agrees(tv, ti, *jeng.query(QUERY_IDS, k=k))
        _assert_ties_lower_first(ti)
    # k past the live rows: the live rows, never a tombstone
    dead = [r for r in range(300) if r not in (7, 140, 201, 260, 299)]
    teng.remove_candidates(dead)
    jeng.remove_candidates(dead)
    tv, ti = teng.query(Q, k=10)
    assert tv.shape == (5, 5)
    _assert_topk_agrees(tv, ti, *jeng.query(QUERY_IDS, k=10))
    assert len(teng._calls.keys()) == (1 if scan else 0)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_query_rerank_matches_jax(pool_dtype, scan):
    teng, state = _port(pool_dtype, scan)
    jeng = _jax(pool_dtype, scan)
    for of in (None, OVERLAP):
        jv, ji = jeng.query_rerank(STATE_NP, QUERY_IDS, k=4, shortlist=12,
                                   overlap_feat=of)
        tv, ti = teng.query_rerank(state, Q, k=4, shortlist=12,
                                   overlap_feat=None if of is None
                                   else torch.from_numpy(of))
        _assert_rerank_agrees(tv, ti, jv, ji)
    assert len(teng._calls.keys()) == (2 if scan else 0)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_ivf_and_coarse_match_jax(monkeypatch, pool_dtype, scan):
    jeng, teng = _ivf_pair(monkeypatch, pool_dtype, scan)
    for k, nprobe in ((10, 2), (400, 3)):   # 400: past the probed rows
        _assert_ivf_agrees(*teng.query_ivf(Q, k=k, nprobe=nprobe),
                           *jeng.query_ivf(QUERY_IDS, k=k, nprobe=nprobe))
    for k, shortlist in ((5, 48), (400, 300)):
        _assert_ivf_agrees(
            *teng.ivf.query_coarse(Q, k=k, shortlist=shortlist),
            *jeng.ivf.query_coarse(QUERY_IDS, k=k, shortlist=shortlist,
                                   approx_recall=None))
    assert len(teng._calls.keys()) == (4 if scan else 0)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_scan_chunks_true_equals_false(pool_dtype):
    """Both flags run the same bodies on the CPU: equal tensors."""
    out = {}
    for scan in (True, False):
        eng, state = _port(pool_dtype, scan)
        res = [eng.query(QUERY_IDS, k=12), eng.query_rerank(
            state, QUERY_IDS, k=3, shortlist=9, overlap_feat=OVERLAP)]
        if pool_dtype != "int4":
            eng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, coarse_tokens=2)
            res += [eng.query_ivf(QUERY_IDS, k=7, nprobe=2),
                    eng.ivf.query_coarse(QUERY_IDS, k=7, shortlist=40)]
        out[scan] = res
    for a, b in zip(out[True], out[False], strict=True):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_keys_repeat_and_numpy_inputs_share_them():
    eng, _ = _port("bf16", True)
    first = eng.query(QUERY_IDS, k=10)
    again = eng.query(torch.from_numpy(QUERY_IDS), k=10)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    (stats,) = eng._calls.stats()
    assert stats["calls"] == 2 and stats["replays"] == 0   # eager here
    eng.query(QUERY_IDS[:2], k=10)
    eng.query(QUERY_IDS, k=4)
    eng.chunk_size = 64                 # a closed-over int joins the key
    eng.query(QUERY_IDS, k=4)
    assert len(eng._calls.keys()) == 4


# ----------------------------------------------------------- invalidation
@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_results_follow_the_lifecycle_like_jax(pool_dtype, tmp_path):
    jeng = _jax(pool_dtype, True, PLAIN_IDS[:150], reserve=20)
    teng, state = _port(pool_dtype, True, PLAIN_IDS[:150], reserve=20)

    def same(what):
        _assert_topk_agrees(*teng.query(Q, k=10),
                            *jeng.query(QUERY_IDS, k=10))
        _assert_rerank_agrees(
            *teng.query_rerank(state, Q, k=3, shortlist=10),
            *jeng.query_rerank(STATE_NP, QUERY_IDS, k=3, shortlist=10))
        assert len(teng._calls.keys()) == 2, what

    same("built")
    v0 = teng.version
    # 30 rows: 20 into the reserve, then the pool grows
    teng.add_candidates(PLAIN_IDS[150:180])
    jeng.add_candidates(PLAIN_IDS[150:180])
    assert teng.version > v0 and teng._calls.keys() == []
    same("added")
    _, top = jeng.query(QUERY_IDS, k=1)
    dead = sorted(set(np.asarray(top).ravel().tolist()) | {3, 151})
    v0 = teng.version
    teng.remove_candidates(dead)
    jeng.remove_candidates(dead)
    assert teng.version > v0 and teng._calls.keys() == []
    same("removed")
    assert not set(teng.query(Q, k=10)[1].flatten().tolist()) & set(dead)
    v0 = teng.version
    np.testing.assert_array_equal(teng.compact().numpy(), jeng.compact())
    assert teng.version > v0 and teng._calls.keys() == []
    same("compacted")
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    teng.save_index(tpath)
    jeng.save_index(jpath)
    v0 = teng.version
    teng.load_index(tpath)
    jeng = _jax(pool_dtype, True).load_index(jpath)
    assert teng.version > v0 and teng._calls.keys() == []
    same("reloaded")
    v0 = teng.version
    teng.params = teng.params           # new params: a new version too
    assert teng.version > v0 and teng._calls.keys() == []


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_ivf_follows_removals_and_rebuilds_like_jax(monkeypatch, pool_dtype):
    jeng, teng = _ivf_pair(monkeypatch, pool_dtype, True)
    _assert_ivf_agrees(*teng.query_ivf(Q, k=6, nprobe=2),
                       *jeng.query_ivf(QUERY_IDS, k=6, nprobe=2))
    _, top = teng.query_ivf(Q, k=2, nprobe=K_CLUSTERS)
    dead = sorted(set(top.flatten().tolist()))
    teng.remove_candidates(dead)
    jeng.remove_candidates(dead)
    assert teng._calls.keys() == []
    _, pi = teng.query_ivf(Q, k=6, nprobe=K_CLUSTERS)
    _, ci = teng.ivf.query_coarse(Q, k=6, shortlist=60)
    assert not (set(pi.flatten().tolist()) | set(ci.flatten().tolist())) \
        & set(dead)
    # the whole pool shortlisted: JAX's coarse stage may still shortlist a
    # row removed after the build (a wasted slot), the port's never does
    _assert_ivf_agrees(*teng.ivf.query_coarse(Q, k=6, shortlist=300),
                       *jeng.ivf.query_coarse(QUERY_IDS, k=6, shortlist=300,
                                              approx_recall=None))
    # a rebuild after the removal: a new version, JAX's result
    jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   coarse_tokens=3)
    _pinned_kmeans(monkeypatch, jeng)
    v0 = teng.version
    teng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                   coarse_tokens=3)
    assert teng.version > v0 and teng._calls.keys() == []
    _assert_ivf_agrees(*teng.query_ivf(Q, k=6, nprobe=3),
                       *jeng.query_ivf(QUERY_IDS, k=6, nprobe=3))
    assert len(teng._calls.keys()) == 1


# --------------------------------------------------------------- the eval
def _eval_split(n, seed):
    cfg = _small_cfg()
    rng = np.random.default_rng(seed)
    return {"question": rng.integers(0, cfg.vocab_size, (
                n, cfg.question_len)).astype(np.int32),
            "answer": rng.integers(0, cfg.vocab_size, (
                n, cfg.answer_len)).astype(np.int32),
            "overlap_feat": rng.random((n, 2)).astype(np.float32),
            "label": (rng.random(n) < 0.3).astype(np.int32),
            "group": np.repeat(np.arange(n // 10 + 1), 10)[:n]}


@pytest.fixture(scope="module")
def eval_pair():
    jcfg = _small_cfg(sim_weight_init="xavier")
    jtcfg = JTrainerConfig()
    jt = JTrainer(jcfg, jtcfg, donate=False)
    params, state, _ = jax.device_get(jt.init())
    return jt, (_tcfg(jcfg), _t_trainer_cfg(jtcfg)), params, state


@pytest.mark.parametrize("n", [60, _SORTED_METRICS_THRESHOLD + 52])
def test_eval_step_matches_jax(eval_pair, n):
    jt, cfgs, params, state = eval_pair
    tt = Trainer(*cfgs, device="cpu")
    split = _eval_split(n, seed=n)
    want = jt._eval_step(params, state, {k: jnp.asarray(v)
                                         for k, v in split.items()})
    tp, ts = params_from_numpy(params, state, "cpu")
    for _ in range(2):                 # the second call reuses the key
        got = tt.evaluate(tp, ts, split)
        for key in ("map", "mrr", "auc"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got["prob"], np.asarray(want["prob"]),
                                   **STEP_TOL)
    (stats,) = tt.evals.stats()
    assert stats["key"] == ("eval",) and stats["calls"] == 2


def test_eval_step_reads_params_in_place_and_keys_their_addresses(
        eval_pair):
    _, cfgs, params, state = eval_pair
    tt = Trainer(*cfgs, device="cpu")
    split = tt._full_batch(_eval_split(60, seed=1))
    tp, ts = params_from_numpy(params, state, "cpu")
    first = tt._eval_step(tp, ts, split)
    tp["sim"]["w"].mul_(2.0)            # in place: the same key, new values
    second = tt._eval_step(tp, ts, split)
    assert len(tt.evals.keys()) == 1
    assert not torch.equal(first["prob"], second["prob"])
    other = params_from_numpy(params, state, "cpu")   # other addresses
    third = tt._eval_step(*other, split)
    assert len(tt.evals.keys()) == 2
    assert torch.equal(third["prob"], first["prob"])


# --------------------------------------------------------------- the server
@pytest.mark.parametrize("pad", [True, False])
def test_server_pad_buckets_matches_jax(pad):
    jeng = _jax("bf16", True, PLAIN_IDS)
    jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS)
    teng, state = _port("bf16", True, PLAIN_IDS)
    cent, assign = JIVF._kmeans(jeng.ivf._coarse_candidates(), K_CLUSTERS,
                                iters=ITERS, seed=SEED)
    orig = TIVF._kmeans
    TIVF._kmeans = lambda vecs, k, iters, seed: (
        torch.from_numpy(np.array(cent)),
        torch.from_numpy(np.array(assign)).to(torch.int64))
    try:
        teng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS)
    finally:
        TIVF._kmeans = orig
    jsrv = JServer(jeng, state=STATE_NP, max_batch=8, pad_buckets=pad)
    tsrv = QAServer(teng, state=state, max_batch=8, pad_buckets=pad)
    try:
        for n in (1, 3, 5, 8):
            rows = QUERY_IDS[np.arange(n) % 5].tolist()
            for extra in ({}, {"rerank": 6}, {"shortlist": 40}):
                req = {"tokens": rows, "k": 4, **extra}
                t, j = tsrv.handle_query(req), jsrv.handle_query(req)
                assert len(t["results"]) == len(j["results"]) == n
                for tr, jr in zip(t["results"], j["results"]):
                    assert [i for i, _ in tr["topk"]] == \
                        [i for i, _ in jr["topk"]], (n, extra)
                    np.testing.assert_allclose(
                        [v for _, v in tr["topk"]],
                        [v for _, v in jr["topk"]], rtol=1e-5, atol=1e-6)
        ts, js = tsrv.stats.snapshot(), jsrv.stats.snapshot()
        assert ts["device_dispatch_rows"] == js["device_dispatch_rows"] \
            == (3 * (1 + 4 + 8 + 8) if pad else 3 * 17)
        # one graph a bucket and path: 1, 4, 8 rows padded, or 1, 3, 5, 8
        assert len(teng._calls.keys()) == (3 if pad else 4) * 3
    finally:
        tsrv.close()
        jsrv.close()
