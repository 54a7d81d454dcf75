"""The port's HTTP retrieval service against the JAX package's, on CPU:
both servers over the same bf16 pool and weights, asked the same requests
in the same order, must answer the same JSON -- query (tokens, short rows,
text), rerank, the IVF coarse shortlist, /add, /remove, /compact, the 400s
and 404s, and the micro-batcher.

The JAX engine runs its Pallas kernels in interpret mode; the port's runs
its plain scorers (CPU tensors).  k-means draws from each package's own
RNG, so the port's IVF is given JAX's clustering, as in
``test_torch_ivf.py``.

Tolerance: numbers in the replies at rtol 1e-5 (atol 1e-6): the scores of
the same bf16 pool up to float32 summation order, as in
``test_torch_engine.py``; candidate indices, counts and error messages
equal.  Latencies and the padded row counts of the JAX server (which pads
each call to a power of two to bound its compiles) are left out.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JM
from mms_answer_selection_tpu.serve import QAServer as JServer
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.serve import ivf as JIVF
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.serve import QAServer, QueryEngine
from mms_answer_selection_tpu_torch.serve import ivf as TIVF

JCFG = JM.MMSQAConfig(
    vocab_size=34, embed_dim=16, question_len=6, answer_len=6,
    sim_measures=2,
    blocks=(JM.ConvBlock(3, 3, 4, "ave", 2, 2),
            JM.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TM.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TM.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
WORDS = np.asarray([f"w{i}" for i in range(32)])   # + unknown 32, pad 33
K_CLUSTERS, SEED, ITERS = 4, 1, 5
UNTIMED = {"latency_ms", "p50_ms", "p90_ms", "device_dispatch_rows"}
_rng = np.random.default_rng(5)
CAND_IDS = _rng.integers(0, 34, (40, 6)).astype(np.int32)


def _weights():
    rng = np.random.default_rng(0)
    params, state = JM.mms_qa_init(jax.random.PRNGKey(0), JCFG)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), params)
    state = jax.tree.map(lambda x: np.abs(rng.normal(size=x.shape)).astype(
        np.float32) + 0.3, state)
    return params, state


PARAMS_NP, STATE_NP = _weights()


def _call(base, path, payload=None, raw=None):
    """(status, JSON body) of a GET (no payload) or POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _assert_json_close(t, j, path=""):
    if isinstance(j, dict):
        assert isinstance(t, dict), path
        keys = set(j) - UNTIMED
        assert set(t) - UNTIMED == keys, (path, set(t) ^ set(j))
        for k in keys:
            _assert_json_close(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (path, t, j)
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_json_close(a, b, f"{path}/{i}")
    elif isinstance(j, float):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=path)
    else:
        assert type(t) is type(j) and t == j, (path, t, j)


def _engines(ivf: bool):
    jeng = JEngine(PARAMS_NP, JCFG, pool_dtype=jnp.bfloat16,
                   interpret=True).build_index(CAND_IDS)
    params, _ = params_from_numpy(PARAMS_NP, {}, "cpu")
    teng = QueryEngine(params, TCFG, pool_dtype="bf16",
                       device="cpu").build_index(CAND_IDS)
    if ivf:
        jeng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED, kmeans_iters=ITERS,
                       coarse_tokens=2)
        cent, assign = JIVF._kmeans(jeng.ivf._coarse_candidates(), K_CLUSTERS,
                                    iters=ITERS, seed=SEED)
        orig = TIVF._kmeans
        TIVF._kmeans = lambda vecs, k, iters, seed: (
            torch.from_numpy(np.array(cent)),
            torch.from_numpy(np.array(assign)).to(torch.int64))
        try:
            teng.build_ivf(n_clusters=K_CLUSTERS, seed=SEED,
                           kmeans_iters=ITERS, coarse_tokens=2)
        finally:
            TIVF._kmeans = orig
    return teng, jeng


def _servers(ivf: bool, **kw):
    teng, jeng = _engines(ivf)
    _, state = params_from_numpy({}, STATE_NP, "cpu")
    t = QAServer(teng, state=state, vocab_words=WORDS, **kw).start()
    j = JServer(jeng, state=STATE_NP, vocab_words=WORDS, **kw).start()
    return t, j


@pytest.fixture(scope="module")
def pair():
    t, j = _servers(ivf=True)
    yield (f"http://{t.host}:{t.port}", f"http://{j.host}:{j.port}", t, j)
    t.close()
    j.close()


def _both(pair, path, payload=None, raw=None):
    t_base, j_base = pair[:2]
    (tc, tb), (jc, jb) = (_call(b, path, payload, raw)
                          for b in (t_base, j_base))
    assert tc == jc, (path, payload, tb, jb)
    return tb, jb


QUERIES = [
    {"tokens": _rng.integers(0, 34, (3, 6)).tolist(), "k": 5},
    {"tokens": [1, 2], "k": 4},                      # one short row
    {"tokens": [[5, 6, 7, 8, 9, 10, 11, 12]]},       # a long row, default k
    {"text": "W3 w7 zzz", "k": 4},
    {"text": ["w1 w2 w3", "w30 w31"], "k": 40},      # k past the pool
    {"tokens": _rng.integers(0, 34, (2, 6)).tolist(), "k": 3,
     "rerank": 8},
    {"text": "w4 w5 w6", "k": 2, "rerank": 40},
    {"tokens": _rng.integers(0, 34, (2, 6)).tolist(), "k": 5,
     "shortlist": 12},
]


@pytest.mark.parametrize("req", QUERIES, ids=[
    "tokens", "short-row", "long-row", "text", "k-past-pool", "rerank",
    "rerank-all", "coarse-shortlist"])
def test_query_replies_equal_jax(pair, req):
    tb, jb = _both(pair, "/query", req)
    assert tb["results"] and all(r["topk"] for r in tb["results"])
    _assert_json_close(tb, jb)


BAD = [
    ({"tokens": [[1, 2]], "k": 0}, None),
    ({"tokens": [[1, 2]], "rerank": -1}, None),
    ({"tokens": [[1, 2]], "shortlist": -2}, None),
    ({"tokens": [[1, 2]], "k": "x"}, None),
    ({"tokens": [[1, 2]], "rerank": 4, "shortlist": 4}, None),
    ({"tokens": "1 2"}, None),
    ({"tokens": []}, None),
    ({"tokens": [[1, 99]]}, None),
    ({"tokens": [[1, -1]]}, None),
    ({"tokens": [["a", "b"]]}, None),
    ({"text": 5}, None),
    ({"text": []}, None),
    ({"nothing": 1}, None),
    ([1, 2], None),
    (None, b"{not json"),
    ({"tokens": [[1]] * 1025}, None),
]


@pytest.mark.parametrize("req,raw", BAD, ids=[str(i) for i in range(len(BAD))])
def test_bad_requests_answer_400_as_jax(pair, req, raw):
    tb, jb = _both(pair, "/query", req, raw)
    assert "error" in tb
    assert tb == jb


def test_routes_health_and_stats_equal_jax(pair):
    tb, jb = _both(pair, "/nope")
    assert tb == jb and "no route" in tb["error"]
    tb, jb = _both(pair, "/nope", {})
    assert tb == jb
    for path in ("/healthz", "/stats"):
        tb, jb = _both(pair, path)
        _assert_json_close(tb, jb)
    assert tb["queries_served"] >= 0


def _fresh(**kw):
    t, j = _servers(ivf=False, **kw)
    return (f"http://{t.host}:{t.port}", f"http://{j.host}:{j.port}", t, j)


def test_add_remove_compact_equal_jax():
    pair = _fresh()
    try:
        probe = {"tokens": CAND_IDS[:3].tolist(), "k": 6}
        steps = [
            ("/add", {"tokens": _rng.integers(0, 34, (3, 6)).tolist()}),
            ("/add", {"text": ["w1 w2", "w9 w8 w7"]}),
            ("/add", {"tokens": [4, 5, 6]}),
            ("/remove", {"rows": [0, 3, 41, 3]}),
            ("/remove", {"rows": [45]}),
            ("/compact", {}),
            ("/remove", {"rows": [1]}),
            ("/compact", {}),
        ]
        for path, req in steps:
            tb, jb = _both(pair, path, req)
            _assert_json_close(tb, jb)
            tb, jb = _both(pair, "/query", probe)
            _assert_json_close(tb, jb)
        for path, req in (("/remove", {"rows": [999]}),
                          ("/remove", {"rows": []}),
                          ("/remove", {"rows": [1.5]}),
                          ("/add", {"tokens": []}),
                          ("/add", {"text": 3}),
                          ("/add", [1])):
            tb, jb = _both(pair, path, req)
            assert "error" in tb and tb == jb, (path, req)
        tb, jb = _both(pair, "/query", {"tokens": [[1, 2]],
                                        "shortlist": 4})
        # the one message that names the command line tool
        assert tb["error"] == jb["error"].replace("qa serve", "serve")
    finally:
        pair[2].close()
        pair[3].close()


def test_micro_batcher_coalesces_as_jax():
    """Concurrent requests within the window share one device call; each
    still gets the answer it would alone, equal to JAX's."""
    pair = _fresh(batch_window_ms=200.0)
    try:
        reqs = [{"tokens": _rng.integers(0, 34, (n, 6)).tolist(), "k": 3}
                for n in (1, 2, 1)] + [{"text": "w5 w6", "k": 3}]
        out = {}

        def ask(side, i):
            out[side, i] = _call(pair[side], "/query", reqs[i])

        threads = [threading.Thread(target=ask, args=(s, i))
                   for s in (0, 1) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for i in range(len(reqs)):
            (tc, tb), (jc, jb) = out[0, i], out[1, i]
            assert tc == jc == 200
            _assert_json_close(tb, jb)
        stats = pair[2].stats.snapshot()
        assert stats["queries_served"] == len(reqs)
        assert stats["device_dispatches"] < len(reqs)   # coalesced
        alone = _call(pair[0], "/query", reqs[1])[1]
        _assert_json_close(alone, out[0, 1][1])
    finally:
        pair[2].close()
        pair[3].close()


def test_server_refuses_an_unbuilt_engine():
    params, _ = params_from_numpy(PARAMS_NP, {}, "cpu")
    with pytest.raises(ValueError, match="build_index"):
        QAServer(QueryEngine(params, TCFG, device="cpu"))
