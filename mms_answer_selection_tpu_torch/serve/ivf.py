"""IVF (inverted-file) approximate retrieval over a QueryEngine pool
(counterpart of ``serve/ivf.py``).

Brute force (``QueryEngine.query``) amortizes well over query batches, but
one latency-sensitive query still pays the whole pool.  This is the
classic two-level index in front of the exact kernel:

1. **Coarse representation.**  Replacing MaxSim's ``max_j`` with
   ``mean_j`` makes a candidate enter only through its token mean
   ``v_a = mean_j a_j``, and the coarse score collapses to one dot
   product, ``coarse(q, a) = (sum_{m,i} q_i W_m) . v_a``; the query side is
   the bf16 projection summed over its rows.
2. **k-means** over the coarse vectors (k-means++ seeding on a subsample,
   Lloyd with chunked assignment, on a ``torch.Generator``) groups the
   candidates into K buckets of one width B (overflow spills to the least
   loaded buckets).
3. **Query**: score the K centroids, take the top ``nprobe`` clusters,
   gather their candidates' packed rows (the pools are candidate-major, so
   the gather is ``pool[idx]``) and run the exact kernel on them, one query
   per launch.  ``query_coarse`` instead shortlists over every candidate
   (the dense coarse product, or with ``coarse_tokens`` T > 1 the bf16
   kernel over a mini pool of T token centroids per candidate) and scores
   the shortlist exactly.  With the engine's ``scan_chunks`` each is one
   CUDA graph replay over the query batch (the per-query launches inside
   it, as the JAX package's ``lax.map`` is inside its program).

With ``nprobe == n_clusters`` every live candidate is scored by the exact
kernel, so the result equals ``QueryEngine.query`` (the same per-pair
scores; among equal scores the probe order decides).  Tombstones never
enter a bucket built after their removal, and a removal after the build
is honoured at query time: removed rows come back as index -1, score
-inf.  bf16 and int8 pools only; the reference refuses int4 too.

Where the reference differs by necessity: its k-means RNG (``jax.random``)
has no torch counterpart, so clusters match only when its centroids are
given; ``lax.approx_max_k`` in ``query_coarse`` is an exact top-k here (on
the CPU the reference's lowering is exact too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sim_cross_kernels as sk
from ..ops.embed import embed_lookup
from .query_engine import topk


def _kmeanspp_init(vecs, k: int, generator: torch.Generator):
    """k-means++ seeding: the first seed uniform, each next one drawn with
    probability proportional to its squared distance from the nearest seed
    so far (chosen points have distance 0, so weight ~0)."""
    n, d = vecs.shape
    first = torch.randint(0, n, (1,), generator=generator,
                          device=vecs.device)
    cent = torch.zeros((k, d), dtype=torch.float32, device=vecs.device)
    cent[0] = vecs[first[0]]
    mind = ((vecs - vecs[first]) ** 2).sum(1)
    for i in range(1, k):
        nxt = torch.multinomial(mind + 1e-30, 1, generator=generator)
        cent[i] = vecs[nxt[0]]
        mind = torch.minimum(mind, ((vecs - cent[i]) ** 2).sum(1))
    return cent


def _kmeans(vecs, k: int, *, iters: int = 10, seed: int = 0,
            chunk: int = 65536, init_sample: int = 131072):
    """Lloyd's k-means with k-means++ seeding on a <= ``init_sample``
    subsample.  vecs (N, D) -> (centroids (K, D) float32, assignment (N,)
    int64), both on vecs' device.  Distances are computed ``chunk`` rows
    at a time, so the (N, K) matrix never exists for 1M-row pools.  Empty
    clusters keep their centroid."""
    vecs = vecs.to(torch.float32)
    n, d = vecs.shape
    k = min(k, n)
    g = torch.Generator(device=vecs.device).manual_seed(seed)
    sub = vecs
    if n > init_sample:
        sub = vecs[torch.randperm(n, generator=g,
                                  device=vecs.device)[:init_sample]]
    cent = _kmeanspp_init(sub, k, g)
    assign = None
    for _ in range(max(1, iters)):
        # argmin_k |x - c|^2 == argmin_k (c.c - 2 x.c)
        c2 = (cent * cent).sum(1)[None, :]
        assign = torch.cat([(c2 - 2.0 * (vecs[a:a + chunk] @ cent.T))
                            .argmin(1) for a in range(0, n, chunk)])
        sums = torch.zeros((k, d), dtype=torch.float32,
                           device=vecs.device).index_add_(0, assign, vecs)
        cnts = torch.bincount(assign, minlength=k).to(torch.float32)
        cent = torch.where((cnts > 0)[:, None],
                           sums / cnts.clamp(min=1.0)[:, None], cent)
    return cent, assign


class IVFIndex:
    """Two-level index over a built bf16 or int8 ``QueryEngine`` pool with
    candidate ids.  Construct with ``QueryEngine.build_ivf``."""

    def __init__(self, engine, *, n_clusters: int = 256,
                 bucket: int | None = None, kmeans_iters: int = 10,
                 seed: int = 0, coarse_tokens: int = 1):
        if engine.pool is None:
            raise ValueError("engine has no index; call build_index first")
        if engine.pool_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"IVF supports bf16 and int8 pools, as the reference does; "
                f"got {engine.pool_dtype!r} (int4 is capacity-only, served "
                f"behind query_rerank)")
        if engine.mesh is not None:
            raise ValueError("IVF v1 is single-device; meshed pools use "
                             "the sharded brute-force path")
        if engine.cand_token_ids is None:
            raise ValueError("IVF needs build_index(candidate_ids); "
                             "from-tokens pools keep no ids")
        if int(coarse_tokens) < 1:
            raise ValueError("coarse_tokens must be >= 1")
        self.engine = engine
        self.n_clusters = min(n_clusters, engine.pool_size)
        self.coarse_tokens = int(coarse_tokens)
        self._build(bucket, kmeans_iters, seed)

    # --------------------------------------------------------------- build
    def _coarse_candidates(self):
        """(C, D) float32 token mean of each candidate, 65,536 at a time."""
        eng = self.engine
        ids = eng.cand_token_ids
        out = torch.empty((ids.shape[0], eng.cfg.embed_dim),
                          dtype=torch.float32, device=eng.device)
        for a in range(0, ids.shape[0], 65536):
            out[a:a + 65536] = embed_lookup(
                eng.params["embed"], ids[a:a + 65536]).to(torch.float32) \
                .mean(1)
        return out

    def _token_centroids(self, t: int, iters: int = 5):
        """(C, T, D) float32: each candidate's tokens compressed to T
        centroids by a per-candidate Lloyd, batched over 16,384
        candidates.  Farthest-point seeding covers every distinct token
        when a candidate has <= T of them, so then the centroids are its
        token set and the coarse MaxSim is exact."""
        eng = self.engine
        ids = eng.cand_token_ids
        c = ids.shape[0]
        out = torch.empty((c, t, eng.cfg.embed_dim), dtype=torch.float32,
                          device=eng.device)
        for a in range(0, c, 16384):
            tok = embed_lookup(eng.params["embed"],
                               ids[a:a + 16384]).to(torch.float32)
            rows = torch.arange(tok.shape[0], device=tok.device)
            cents = [tok[:, 0]]
            mind = ((tok - tok[:, :1]) ** 2).sum(-1)          # (B, W2)
            for _ in range(t - 1):
                cn = tok[rows, mind.argmax(-1)]
                cents.append(cn)
                mind = torch.minimum(mind,
                                     ((tok - cn[:, None]) ** 2).sum(-1))
            cent = torch.stack(cents, 1)                      # (B, T, D)
            for _ in range(iters):
                d2 = ((tok[:, :, None] - cent[:, None]) ** 2).sum(-1)
                hot = torch.nn.functional.one_hot(d2.argmin(-1), t) \
                    .to(torch.float32)                        # (B, W2, T)
                sums = torch.einsum("bwt,bwd->btd", hot, tok)
                cnt = hot.sum(1)                              # (B, T)
                cent = torch.where((cnt > 0)[..., None],
                                   sums / cnt.clamp(min=1.0)[..., None],
                                   cent)
            out[a:a + 16384] = cent
        return out

    def _build(self, bucket, kmeans_iters, seed):
        eng = self.engine
        vecs = self._coarse_candidates()
        cent, assign = _kmeans(vecs, self.n_clusters, iters=kmeans_iters,
                               seed=seed)
        k = self.n_clusters = int(cent.shape[0])
        assign = assign.cpu().numpy()
        # tombstoned rows never enter a bucket
        live = np.ones(eng.pool_size, bool)
        live[eng.deleted.numpy()] = False
        counts = np.bincount(assign[live], minlength=k)
        b = max(int(counts.max()) if bucket is None else int(bucket), 1)
        order = np.argsort(assign, kind="stable")
        order = order[live[order]]
        # each cluster takes its first b candidates in index order
        cl = assign[order]
        rank = np.arange(order.size) - np.searchsorted(cl, cl, side="left")
        fits = rank < b
        bucket_map = np.full((k, b), -1, np.int64)
        bucket_map[cl[fits], rank[fits]] = order[fits]
        loads = np.bincount(cl[fits], minlength=k)
        # capacity spill: overflow rides the least-loaded clusters, where
        # it is exactly scored whenever that cluster is probed
        spilled = order[~fits]
        for cand in spilled:
            to = int(np.argmin(loads))
            if loads[to] >= b:
                raise ValueError(f"bucket={b} cannot hold {eng.pool_size} "
                                 f"candidates in {k} clusters")
            bucket_map[to, loads[to]] = cand
            loads[to] += 1
        self.spilled = int(spilled.size)
        self.bucket = b
        self.centroids = cent
        self.bucket_map = torch.from_numpy(bucket_map).to(eng.device)
        self.coarse = vecs.to(torch.bfloat16)
        self.coarse_pool = None
        if self.coarse_tokens > 1:
            self.coarse_pool = sk.pack_candidate_pool(
                self._token_centroids(self.coarse_tokens))

    def state(self) -> dict:
        """The arrays ``QueryEngine.save_index`` writes."""
        out = {"ivf_meta": np.asarray([self.n_clusters, self.bucket,
                                       self.spilled, self.coarse_tokens],
                                      np.int64),
               "ivf_bucket_map": self.bucket_map,
               "ivf_centroids": self.centroids,
               "ivf_coarse": self.coarse}
        if self.coarse_pool is not None:
            out["ivf_coarse_pool"] = self.coarse_pool
        return out

    @classmethod
    def restore(cls, engine, get):
        """The index ``state`` describes, over ``engine``'s pool; ``get``
        reads an array of the file onto the engine's device."""
        iv = cls.__new__(cls)
        iv.engine = engine
        iv.n_clusters, iv.bucket, iv.spilled, iv.coarse_tokens = (
            int(v) for v in get("ivf_meta").tolist())
        iv.bucket_map = get("ivf_bucket_map")
        iv.centroids = get("ivf_centroids")
        iv.coarse = get("ivf_coarse")
        iv.coarse_pool = (get("ivf_coarse_pool") if iv.coarse_tokens > 1
                          else None)
        return iv

    # --------------------------------------------------------------- query
    def _route(self, q_tokens, proj):
        """bf16 projected queries for the coarse stage: the bf16 exact
        stage's own projection, or a separate one for int8 pools."""
        if self.engine.pool_dtype == "bf16":
            return proj[0]
        return sk.project_queries(q_tokens, self.engine.params["sim"]["w"])

    def _exact(self, proj, i: int, idx, ok, k: int):
        """Query i's top-k over candidates ``idx`` (``ok`` marks real
        ones; the engine's ``dead`` mask, the removed) scored by the exact
        kernel; other slots come back as index -1, score -inf."""
        eng = self.engine
        safe = idx.clamp(min=0)
        ok = ok & ~eng.dead[safe]
        aux = None if eng.aux is None else eng.aux[safe]
        s = eng.score(tuple(p[i:i + 1] for p in proj), eng.pool[safe], aux)
        v, j = topk(torch.where(ok, s[0], -torch.inf), k)
        return v, torch.where(ok[j], idx[j], -1)

    def _stack(self, out):
        return (torch.stack([v for v, _ in out]),
                torch.stack([ix for _, ix in out]))

    def query(self, query_ids, k: int = 10, *, nprobe: int = 8):
        """(scores (Nq, k'), candidate indices (Nq, k')) over the probed
        buckets, k' = min(k, nprobe * bucket, pool size).  Slots beyond the
        probed set's live candidates return index -1 with score -inf."""
        eng = self.engine
        if eng.pool is None:
            raise RuntimeError("build_index first")
        nprobe = min(nprobe, self.n_clusters)
        k = min(k, nprobe * self.bucket, eng.pool_size)
        return eng._dispatch(("ivf", k, nprobe),
                             lambda q: self._probe(q, k, nprobe),
                             torch.as_tensor(query_ids))

    def _probe(self, query, k: int, nprobe: int):
        eng = self.engine
        q_tokens = eng._tokens(query)
        proj = eng.project(q_tokens)
        d = self.centroids.shape[1]
        u = self._route(q_tokens, proj).to(torch.float32).sum(1)[:, :d]
        _, cl = topk(u @ self.centroids.T, nprobe)             # (Nq, P)
        valid = self.bucket_map >= 0
        return self._stack([
            self._exact(proj, i, self.bucket_map[cl[i]].reshape(-1),
                        valid[cl[i]].reshape(-1), k)
            for i in range(cl.shape[0])])

    def query_coarse(self, query_ids, k: int = 10, *, shortlist: int = 1024,
                     approx_recall: float | None = 0.95):
        """Flat two-stage retrieval: a coarse score for every candidate
        (the dense product with the token means, or with coarse_tokens > 1
        the bf16 MaxSim kernel over the token-centroid mini pool), then the
        exact kernel on the top ``shortlist``.  Returns (scores (Nq, k'),
        indices (Nq, k')), k' = min(k, shortlist, pool size).

        ``approx_recall`` is taken for the JAX package's signature, where
        it picks the TPU's approximate top-k for large shortlists; the
        shortlist here is always selected exactly, whatever its value."""
        del approx_recall
        eng = self.engine
        if eng.pool is None:
            raise RuntimeError("build_index first")
        shortlist = min(shortlist, eng.pool_size)
        k = min(k, shortlist)
        return eng._dispatch(("coarse", k, shortlist),
                             lambda q: self._coarse(q, k, shortlist),
                             torch.as_tensor(query_ids))

    def _coarse(self, query, k: int, shortlist: int):
        eng = self.engine
        q_tokens = eng._tokens(query)
        proj = eng.project(q_tokens)
        qw = self._route(q_tokens, proj)
        if self.coarse_pool is not None:
            cs = sk.bilinear_maxsim_scores(qw, self.coarse_pool)
        else:
            d = self.coarse.shape[1]
            cs = qw.to(torch.float32).sum(1)[:, :d] \
                @ self.coarse.to(torch.float32).T
        # tombstones never shortlist
        cs = cs.masked_fill(eng.dead[:eng.pool_size], -torch.inf)
        _, sl = topk(cs, shortlist)                              # (Nq, S)
        ok = torch.ones(shortlist, dtype=torch.bool, device=eng.device)
        return self._stack([self._exact(proj, i, sl[i], ok, k)
                            for i in range(sl.shape[0])])


def ivf_recall(engine, query_ids, *, k: int = 10, nprobe: int = 8,
               method: str = "ivf", shortlist: int = 1024, brute_idx=None):
    """Fraction of the brute-force top-k that the approximate search
    recovers, averaged over queries.  method: "ivf" (cluster-routed,
    ``nprobe``) or "coarse" (flat shortlist, ``shortlist``).  ``brute_idx``
    (Nq, k) lets a sweep compute the exact top-k once."""
    if brute_idx is None:
        _, brute_idx = engine.query(query_ids, k=k)
    if method == "coarse":
        _, ii = engine.ivf.query_coarse(query_ids, k=k, shortlist=shortlist)
    else:
        _, ii = engine.query_ivf(query_ids, k=k, nprobe=nprobe)
    bi, ii = brute_idx.cpu().numpy(), ii.cpu().numpy()
    hits = [len(set(b.tolist()) & set(i[i >= 0].tolist())) / len(b)
            for b, i in zip(bi, ii)]
    return float(np.mean(hits))
