"""The comparisons that decide ``correct``: the numbers read from the
program's outputs against the plain reference.  Each traffic file holds
the limit of each number (``limits``); PERF.md gives the readings each
limit was set from.

Retrieval (``topk``), per sampled query, in units of the standard
deviation of the reference's scores over the whole pool (the scale on
which candidates are told apart):

* ``score_gap``: the largest |returned score - the reference's score of
  the returned candidate|;
* ``rank_gap``: the largest amount by which the reference's score of the
  candidate returned at position r lies below the reference's r-th best
  score.  A candidate returned twice, or an index outside the pool,
  counts as the pool's worst candidate there.

Training (``training``), over the steps the reference follows:

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  of the first ``check_losses`` steps;
* ``grad_gap``: the first gradient as AdaDelta took it, its norm read
  from the solver's state after one step (h = (1 - m) g^2, so
  |g| = sqrt(sum h / (1 - m))), against the reference's, by the worst
  leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
* ``median_change_gap``: the parameters' change over the followed steps,
  | |d| - |d_ref| | / max(|d_ref|, the median leaf's |d_ref|), of the
  median leaf; a leaf counts by the gradient over those steps (AdaDelta's
  running average of g^2 in the reference).  The median, not the worst
  leaf: over the 51 followed steps one small leaf (the embedding's bias,
  the first conv) can carry rounding noise that the recipe's start from
  W = 0 amplifies (train-mode BN over a near-constant map), and reads up
  to a fifth on some seeds, the reference against itself too (PERF.md).

Leaves whose reference gradient is rounding noise (a conv bias under
train-mode BN) are moved by AdaDelta's normalized step alone; they are
left out of a number by a rule on the reference's gradient, under a
thousandth of the median leaf's, and never by name.
"""

from __future__ import annotations

import math
import statistics

import torch

NOISE = 1e-3


def topk(ref: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
         k: int) -> dict:
    """ref (S, C) reference scores; vals, idx (S, k) the returned lists."""
    c = ref.shape[1]
    idx = idx.to(ref.device, torch.int64)
    vals = vals.to(ref.device, torch.float32)
    std = ref.std(dim=1, keepdim=True)
    best = ref.topk(k, dim=1).values
    at = ref.gather(1, idx.clamp(0, c - 1))
    bad = (idx < 0) | (idx >= c)
    seen = torch.zeros_like(bad)
    for r in range(1, k):       # a repeat of an earlier position
        seen[:, r] = (idx[:, :r] == idx[:, r:r + 1]).any(1)
    worst = ref.min(dim=1, keepdim=True).values.expand_as(at)
    at = torch.where(bad | seen, worst, at)
    return {"score_gap": float(((vals - at).abs() / std).max()),
            "rank_gap": float((torch.clamp(best - at, min=0) / std).max())}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _gaps(got: dict, want: dict, counted) -> list:
    """| |got| - |want| | / max(|want|, the median leaf's |want|) of each
    counted leaf."""
    med = statistics.median(want[k] for k in counted)
    return [abs(got[k] - want[k]) / max(want[k], med) for k in counted]


def counted(grad_norms: dict) -> list:
    """The leaves whose reference gradient is above rounding noise."""
    med = statistics.median(grad_norms.values())
    return [k for k, n in grad_norms.items() if n >= NOISE * med]


def grad_norms(h_first: dict, momentum: float) -> dict:
    """Each leaf's first gradient norm, read from AdaDelta's accumulator
    after one step: h = (1 - m) g^2."""
    return {k: math.sqrt(float(h.double().sum()) / (1.0 - momentum))
            for k, h in h_first.items()}


def training(losses, g_first: dict, params: dict, ref: dict,
             check_losses: int) -> dict:
    """losses: the program's first losses; g_first: its first gradient's
    norm by leaf (``grad_norms``); params: its leaves after the followed
    steps; ref: ``reference.plain.train``'s result."""
    want = ref["losses"].double().tolist()
    loss_gap = max(abs(float(losses[s]) - want[s]) / abs(want[s])
                   for s in range(check_losses))
    g_ref = _norms(ref["grads"])
    grad_gap = max(_gaps(g_first, g_ref, counted(g_ref)))
    d_ref = _norms({k: ref["params"][k] - ref["init"][k] for k in params})
    d_got = _norms({k: params[k].to(ref["init"][k].device) - ref["init"][k]
                    for k in params})
    # the gradient over the followed steps, from AdaDelta's average of g^2
    g_run = {k: math.sqrt(float(h.double().sum())) for k, h in
             ref["h"].items()}
    change = _gaps(d_got, d_ref, counted(g_run))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "median_change_gap": statistics.median(change)}
