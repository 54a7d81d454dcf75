"""Query engine: index a candidate pool, score queries, take the top-k, and
optionally rerank a shortlist with the full model (counterpart of
``serve/query_engine.py``).

``build_index`` embeds and packs the pool once.  ``query`` projects the
query tokens through the learned metric and scores every candidate with
the MaxSim kernel of the pool's dtype (bf16 or int8); ``query_rerank``
shortlists with it, gathers the shortlisted candidate ids on the device,
rescoring those pairs with the V4 interaction model, and returns the top-k
by P(correct).

Ties: ``lax.top_k`` puts the lower index first, while ``torch.topk`` on
CUDA promises no order.  ``topk`` below fixes the reference's rule.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.mms_qa import MMSQAConfig, mms_qa_apply
from ..ops.embed import embed_lookup
from ..ops.sim_cross_kernels import (
    bilinear_maxsim_scores,
    bilinear_maxsim_scores_int8,
    pack_candidate_pool,
    pack_candidate_pool_int8,
    project_queries,
    project_queries_int8,
)
from ..utils.tree import tree_map

POOL_DTYPES = ("bf16", "int8")


def topk(scores: torch.Tensor, k: int):
    """Top-k along the last axis, sorted descending, lower index first
    among equal values, and -0.0 below +0.0, as ``lax.top_k`` orders them.

    Each float32 score maps to an int32 whose order is that total order;
    the index, complemented, fills the low 32 bits of an int64 key, so the
    keys are distinct and ``torch.topk`` on them has one answer."""
    n = scores.shape[-1]
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + (0xFFFFFFFF - idx)
    pos = torch.topk(keys, k, dim=-1).indices
    return torch.gather(scores, -1, pos), pos


def topk_merge(vals: torch.Tensor, idxs: torch.Tensor, k: int):
    """Merge per-shard top-k lists: (S, Nq, k) -> global (Nq, k)."""
    s, nq, kk = vals.shape
    flat_v = vals.permute(1, 0, 2).reshape(nq, s * kk)
    flat_i = idxs.permute(1, 0, 2).reshape(nq, s * kk)
    top_v, pos = topk(flat_v, k)
    return top_v, torch.gather(flat_i, 1, pos)


class QueryEngine:
    """Learned-metric retrieval over a fixed candidate pool.

    params / state: the model's parameter and BN-state trees as tensors
    (``convert.params_from_numpy``); the engine uses 'embed' and the
    metric 'sim' to score, and the whole model to rerank.
    pool_dtype: "bf16" (the serving default) or "int8" (half the bytes,
    about 1% score error; rerank when exactness matters).
    device: where the pool lives and the kernels run (default "cuda").
    """

    def __init__(self, params, cfg: MMSQAConfig, *, pool_dtype: str = "bf16",
                 device=None):
        if cfg.sim_mode != 2:
            raise ValueError("query engine requires the learned bilinear "
                             "metric (sim_mode=2)")
        if pool_dtype not in POOL_DTYPES:
            raise ValueError(f"pool_dtype must be one of {POOL_DTYPES}, got "
                             f"{pool_dtype!r}")
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.pool_dtype = pool_dtype
        self.pool = None
        self.aux = None          # int8 only: (C, 2) scale and mask
        self.pool_size = 0
        self.cand_token_ids = None  # (C, W2) on device; None for from-tokens

    # ------------------------------------------------------------------ build
    def build_index(self, candidate_ids):
        """candidate_ids: int (C, W2) token ids.  Embeds with the model's
        table and packs the pool; keeps the ids on the device so
        ``query_rerank`` can gather shortlisted candidates there."""
        ids = torch.as_tensor(candidate_ids, device=self.device)
        if ids.ndim != 2 or ids.dtype.is_floating_point:
            raise ValueError(f"candidate_ids must be int (C, W2), got "
                             f"{tuple(ids.shape)} {ids.dtype}")
        self._pack(embed_lookup(self.params["embed"], ids))
        self.cand_token_ids = ids
        return self

    def build_index_from_tokens(self, candidate_tokens):
        """candidate_tokens: (C, T, D) precomputed token embeddings in the
        metric's D-dim space.  Such a pool has no ids, so no rerank."""
        tokens = torch.as_tensor(candidate_tokens, dtype=torch.float32,
                                 device=self.device)
        self._pack(tokens)
        self.cand_token_ids = None
        return self

    def _pack(self, tokens):
        if self.pool_dtype == "int8":
            self.pool, self.aux = pack_candidate_pool_int8(tokens)
        else:
            self.pool, self.aux = pack_candidate_pool(tokens), None
        self.pool_size = tokens.shape[0]

    # ------------------------------------------------------------------ query
    def _scores(self, query):
        """(Nq, C) MaxSim scores of int (Nq, W1) ids or (Nq, W1, D)
        token embeddings."""
        if self.pool is None:
            raise RuntimeError("build_index first")
        query = torch.as_tensor(query, device=self.device)
        q_tokens = (query.to(torch.float32) if query.ndim == 3
                    else embed_lookup(self.params["embed"], query))
        w = self.params["sim"]["w"]
        if self.pool_dtype == "int8":
            qw, qs = project_queries_int8(q_tokens, w)
            return bilinear_maxsim_scores_int8(qw, qs, self.pool, self.aux)
        return bilinear_maxsim_scores(project_queries(q_tokens, w), self.pool)

    def query(self, query_ids, k: int = 10):
        """Top-k candidates under the learned metric: (scores (Nq, k'),
        indices (Nq, k')) with k' = min(k, pool size)."""
        scores = self._scores(query_ids)
        return topk(scores, min(k, self.pool_size))

    # ------------------------------------------------------- exact rescoring
    def query_rerank(self, state, query_ids, k: int = 10, *,
                     shortlist: int = 50, overlap_feat=None):
        """Retrieve, then rerank: the kernel shortlists ``shortlist``
        candidates per query, the full model rescores exactly those pairs,
        and the top-k by P(correct) comes back as (probs (Nq, k'),
        candidate indices (Nq, k')).  shortlist is clamped to the pool
        size and k to the shortlist.  Needs ``build_index`` (ids kept)."""
        if self.cand_token_ids is None:
            raise ValueError(
                "query_rerank needs build_index(candidate_ids); a "
                "from-tokens pool keeps no candidate ids to rescore")
        if self.pool_size == 0:
            raise ValueError("no candidates to rerank")
        shortlist = min(shortlist, self.pool_size)
        k = min(k, shortlist)
        query_ids = torch.as_tensor(query_ids, device=self.device)
        _, idx = self.query(query_ids, k=shortlist)            # (Nq, S)
        nq, s = idx.shape
        cand = self.cand_token_ids[idx.reshape(-1)]            # (Nq*S, W2)
        of = (None if overlap_feat is None else torch.repeat_interleave(
            torch.as_tensor(overlap_feat, device=self.device), s, dim=0))
        probs = self.score_pairs(state, torch.repeat_interleave(
            query_ids, s, dim=0), cand, overlap_feat=of).reshape(nq, s)
        vals, order = topk(probs, k)
        return vals, torch.gather(idx, 1, order)

    def score_pairs(self, state, query_ids, candidate_ids, overlap_feat=None):
        """P(correct) of the full interaction model for explicit (query,
        candidate) pairs; zero overlap features when none are given."""
        q = torch.as_tensor(query_ids, device=self.device)
        if overlap_feat is None:
            overlap_feat = torch.zeros((q.shape[0], self.cfg.overlap_features),
                                       dtype=torch.float32, device=self.device)
        batch = {"question": q,
                 "answer": torch.as_tensor(candidate_ids, device=self.device),
                 "overlap_feat": torch.as_tensor(overlap_feat,
                                                 device=self.device)}
        state = tree_map(lambda t: t.to(self.device), state)
        out, _ = mms_qa_apply(self.params, state, batch, self.cfg,
                              train=False)
        return out["prob"][:, 1]
