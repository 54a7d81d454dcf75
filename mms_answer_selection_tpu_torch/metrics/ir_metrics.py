"""IR metric suite: MAP / MRR / AUC / RankAccuracy (counterpart of
``metrics/ir_metrics.py``).

The reference computes these inside TEST-phase graphs as CPU-only layers
(src/caffe/layers/{map,mrr,auc,rank_accuracy}_layer.cpp) and reads them back
as blobs for early stopping.  Here each metric exists twice with *identical
numerics including tie handling*:

* a numpy host function (ground truth / offline eval; a copy of the JAX
  package's), and
* a ``*_torch`` tensor function that runs on the tensors' device with no
  host round trip, in an O(N^2) pairwise-rank form and, for large splits,
  an O(N log N) sorted form (``*_torch_sorted``); the twins of the JAX
  package's ``*_jax`` and ``*_jax_sorted``.

Shared semantics (cited):
* grouping by integer qid; a group counts toward the mean only if it has at
  least one positive AND at least one negative ("effective samples",
  mrr_layer.cpp:60-76, map_layer.cpp:79-97)
* descending sort with strict-greater comparison; equal scores keep
  insertion order (mycompare, map_layer.cpp:34-38) -- reproduced exactly by
  ranking on (score desc, index asc)
* MRR: mean over effective groups of 1/(rank of first positive)
  (mrr_layer.cpp:56-78)
* MAP: AP = sum over positives of (hits-so-far / position) / n_pos
  (map_layer.cpp:74-99)
* AUC: global (ungrouped) rank-sum counting -- walk the sorted list, add the
  number of positives seen above each negative, normalize by P*N
  (auc_layer.cpp:119-134); 0 if there are no positives.  ``ignore_label``
  drops samples before sorting (auc_layer.cpp:64-79).
* RankAccuracy: fraction of pairs with label*(a-b) > 0
  (rank_accuracy_layer.cpp:36-50).

The tensor forms compute in float32, as the reference's in-graph forms do;
counts are int64.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# host (numpy) versions
# ---------------------------------------------------------------------------


def _group_order(scores):
    """Indices sorting scores descending, ties by insertion order."""
    return np.lexsort((np.arange(len(scores)), -np.asarray(scores, np.float64)))


def mean_reciprocal_rank(scores, labels, groups) -> float:
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    groups = np.asarray(groups).astype(np.int64)
    total, effective = 0.0, 0
    for g in np.unique(groups):
        sel = groups == g
        ls = labels[sel][_group_order(scores[sel])]
        if ls.max(initial=0) == 0 or ls.min(initial=1) == 1:
            continue  # needs at least one positive and one negative
        effective += 1
        total += 1.0 / (int(np.argmax(ls == 1)) + 1)
    return total / effective if effective else 0.0


def mean_average_precision(scores, labels, groups) -> float:
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    groups = np.asarray(groups).astype(np.int64)
    total, effective = 0.0, 0
    for g in np.unique(groups):
        sel = groups == g
        ls = labels[sel][_group_order(scores[sel])]
        n_pos = int(ls.sum())
        if n_pos == 0 or n_pos == ls.size:
            continue
        hits = np.cumsum(ls)
        ap = float(np.sum(hits[ls == 1] / (np.nonzero(ls == 1)[0] + 1.0))) / n_pos
        effective += 1
        total += ap
    return total / effective if effective else 0.0


def auc(scores, labels, *, ignore_label: int | None = None) -> float:
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    if ignore_label is not None:
        keep = labels != ignore_label
        scores, labels = scores[keep], labels[keep]
    order = _group_order(scores)
    ls = labels[order]
    high = np.cumsum(ls)
    value = float(np.sum(high * (1 - ls)))
    p = int(ls.sum())
    n = ls.size - p
    if p == 0 or n == 0:  # degenerate split: match the jax twin's 0.0
        return 0.0
    return value / p / n


def rank_accuracy(a, b, labels) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    labels = np.asarray(labels, np.float64).ravel()
    return float(np.mean((labels * (a - b)) > 0))



# ---------------------------------------------------------------------------
# tensor versions (pairwise, O(N^2))
# ---------------------------------------------------------------------------
#
# Rank of sample i inside its group = number of same-group samples strictly
# ahead of it in the (score desc, index asc) order.  All metrics follow from
# pairwise masks.


def _pairwise_ahead(scores):
    """(N, N) bool: [j, i] True if j sorts strictly ahead of i."""
    s = scores.to(torch.float32)
    idx = torch.arange(s.shape[0], device=s.device)
    gt = s[:, None] > s[None, :]
    tie_first = (s[:, None] == s[None, :]) & (idx[:, None] < idx[None, :])
    return gt | tie_first


def _group_masks(labels, groups):
    same = groups[:, None] == groups[None, :]
    pos = labels.to(torch.int32) == 1
    # effective group: has >=1 positive and >=1 negative among its members
    has_pos = torch.any(same & pos[None, :], dim=1)
    has_neg = torch.any(same & ~pos[None, :], dim=1)
    return same, pos, has_pos & has_neg


def _count_effective_groups(same, effective):
    # each sample contributes 1/|group| so every effective group counts once
    group_size = torch.sum(same, dim=1).to(torch.float32)
    return torch.sum(torch.where(effective, 1.0 / group_size, 0.0))


def mean_reciprocal_rank_torch(scores, labels, groups):
    """MRR over (N,) scores / labels / int groups, as a 0-d float32
    tensor."""
    ahead = _pairwise_ahead(scores)
    same, pos, effective = _group_masks(labels, groups)
    n = scores.shape[0]
    rank = torch.sum(ahead & same, dim=0)  # 0-based rank within group
    # first positive of a group = the positive whose rank is minimal
    pos_rank = torch.where(pos, rank, n + 1)
    better = same & pos[None, :] & (pos_rank[None, :] < pos_rank[:, None])
    is_first_pos = pos & ~torch.any(better, dim=1) & effective
    contrib = torch.where(is_first_pos, 1.0 / (rank + 1.0), 0.0)
    n_eff = _count_effective_groups(same, effective)
    return torch.sum(contrib) / torch.clamp(n_eff, min=1.0)


def mean_average_precision_torch(scores, labels, groups):
    """MAP over (N,) scores / labels / int groups, as a 0-d float32
    tensor."""
    ahead = _pairwise_ahead(scores)
    same, pos, effective = _group_masks(labels, groups)
    rank = torch.sum(ahead & same, dim=0)
    # hits at position of i = positives in the group ranked <= rank_i
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    at_or_ahead = (ahead | eye) & same
    hits = torch.sum(at_or_ahead & pos[:, None], dim=0)
    prec = torch.where(pos, hits / (rank + 1.0), 0.0)
    n_pos = torch.sum(same & pos[None, :], dim=1)
    ap_contrib = torch.where(effective & pos,
                             prec / torch.clamp(n_pos, min=1), 0.0)
    n_eff = _count_effective_groups(same, effective)
    return torch.sum(ap_contrib) / torch.clamp(n_eff, min=1.0)


def auc_torch(scores, labels, *, valid=None):
    """Global AUC as a 0-d float32 tensor.  ``valid``: optional bool mask
    (the static-shape replacement for ignore_label filtering)."""
    pos = labels.to(torch.int32) == 1
    if valid is None:
        valid = torch.ones_like(pos)
    neg = ~pos & valid
    pos = pos & valid
    ahead = _pairwise_ahead(scores)
    # pair (i pos, j neg) counts when i sorts ahead of j
    wins = torch.sum(ahead & pos[:, None] & neg[None, :])
    p = torch.sum(pos)
    n = torch.sum(neg)
    return torch.where(p > 0, wins / torch.clamp(p * n, min=1),
                       torch.zeros((), device=scores.device))


def rank_accuracy_torch(a, b, labels):
    # ravel like the numpy twin: (N, 1) score blobs must not broadcast
    # against (N,) labels into an (N, N) pair matrix
    a, b, labels = a.reshape(-1), b.reshape(-1), labels.reshape(-1)
    return torch.mean(((labels * (a - b)) > 0).to(torch.float32))


# ---------------------------------------------------------------------------
# tensor versions (sorted, O(N log N))
# ---------------------------------------------------------------------------
#
# The same numbers for splits too large for an (N, N) mask.  A stable
# argsort of -scores reproduces the (score desc, insertion order) rule;
# a second stable sort by group gives group-major order, and every quantity
# is a segment reduction over at most N segments.


def _group_major(scores, labels, groups):
    order = torch.argsort(-scores.to(torch.float32), stable=True)
    g1, l1 = groups[order], labels.to(torch.int64)[order]
    order2 = torch.argsort(g1, stable=True)  # stable: keeps score order
    g2, l2 = g1[order2], l1[order2]
    n = scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    boundary = torch.ones((n,), dtype=torch.int64, device=scores.device)
    boundary[1:] = (g2[1:] != g2[:-1]).to(torch.int64)
    seg = torch.cumsum(boundary, 0) - 1          # dense segment ids
    start = torch.cummax(torch.where(boundary == 1, idx, 0), 0).values
    pos_in_group = idx - start                   # 0-based rank within group
    return seg, l2, pos_in_group, n


def _segment_sum(x, seg, n):
    return torch.zeros((n,), dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def _segment_reduce(x, seg, n, reduce):
    return torch.zeros((n,), dtype=x.dtype, device=x.device).scatter_reduce_(
        0, seg, x, reduce=reduce, include_self=False)


def _effective_segments(l2, seg, n):
    n_pos = _segment_sum(l2.to(torch.float32), seg, n)
    n_tot = _segment_sum(torch.ones((n,), device=l2.device), seg, n)
    return n_pos, (n_pos > 0) & (n_pos < n_tot)


def mean_average_precision_torch_sorted(scores, labels, groups):
    """O(N log N) MAP; the same numbers as the pairwise form."""
    seg, l2, pos, n = _group_major(scores, labels, groups)
    csum = torch.cumsum(l2, 0)
    # hits-so-far inclusive = csum - csum[segment start] + l2[segment start]
    start_csum = _segment_reduce(torch.where(pos == 0, csum - l2, 0), seg, n,
                                 "amax")[seg]
    hits = csum - start_csum
    prec = torch.where(l2 == 1, hits / (pos + 1.0), 0.0)
    ap_num = _segment_sum(prec, seg, n)
    n_pos, effective = _effective_segments(l2, seg, n)
    ap = torch.where(effective, ap_num / torch.clamp(n_pos, min=1.0), 0.0)
    n_eff = torch.sum(effective.to(torch.float32))
    return torch.sum(ap) / torch.clamp(n_eff, min=1.0)


def mean_reciprocal_rank_torch_sorted(scores, labels, groups):
    """O(N log N) MRR; the same numbers as the pairwise form."""
    seg, l2, pos, n = _group_major(scores, labels, groups)
    first_pos = _segment_reduce(torch.where(l2 == 1, pos, n + 1), seg, n,
                                "amin")
    _, effective = _effective_segments(l2, seg, n)
    rr = torch.where(effective, 1.0 / (first_pos + 1.0), 0.0)
    return torch.sum(rr) / torch.clamp(
        torch.sum(effective.to(torch.float32)), min=1.0)


def auc_torch_sorted(scores, labels):
    """O(N log N) global AUC (the reference's rank-sum walk on the sorted
    list, vectorized).  The rank sum accumulates in float32, as the
    reference's in-graph form does."""
    order = torch.argsort(-scores.to(torch.float32), stable=True)
    ls = labels.to(torch.int64)[order]
    high = torch.cumsum(ls, 0)
    value = torch.sum(high.to(torch.float32) * (1 - ls).to(torch.float32))
    p = torch.sum(ls).to(torch.float32)
    n = ls.shape[0] - p
    return torch.where(p > 0, value / torch.clamp(p * n, min=1.0),
                       torch.zeros((), device=scores.device))
