"""Loss functions with the reference layers' semantics (counterpart of
``ops/losses.py``).

Each returns a scalar tensor; gradients come from autograd and agree with
the JAX package's autodiff of the same expressions, kinks included: a
``max(0, z)`` is ``torch.maximum`` against a zero tensor, whose gradient
at z = 0 is 1/2 as ``jnp.maximum``'s is (``clamp`` and ``relu`` give 0 or
1), and ``|x|`` is ``_abs``, whose gradient at 0 is 1 as ``jnp.abs``'s is
(``torch.abs`` gives 0 there).
"""

from __future__ import annotations

import numpy as np
import torch

# -log(FLT_MIN): the reference caps the per-sample forward loss here
_CE_CAP = float(-np.log(np.float32(np.finfo(np.float32).tiny)))
_KLOG_THRESHOLD = 1e-20  # the reference's kLOG_THRESHOLD (loss_layer.hpp)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(0, x) with jnp.maximum's gradient of 1/2 at the tie."""
    return torch.maximum(torch.zeros_like(x), x)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at x = 0 (and -0.0)."""
    return torch.where(x >= 0, x, -x)


def _pick(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[i, labels[i]]; a negative label counts from the end, as
    ``jnp.take_along_axis`` reads it."""
    idx = labels.to(torch.int64) % x.shape[-1]
    return torch.gather(x, 1, idx[:, None])[:, 0]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          ignore_label: int | None = None) -> torch.Tensor:
    """SoftmaxWithLoss: mean CE over the valid samples, with the FLT_MIN
    probability cap.

    The cap is straight-through: the forward value is capped, the gradient
    stays the analytic prob - label, as in the reference's backward.  With
    ``ignore_label`` the samples of that label are left out of the sum and
    of the count (the reference's VALID normalization)."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -_pick(logp, labels)
    per = per - (per - torch.clamp(per, max=_CE_CAP)).detach()
    if ignore_label is not None:
        valid = (labels != ignore_label).to(logits.dtype)
        return torch.sum(per * valid) / torch.clamp(torch.sum(valid), min=1.0)
    return torch.mean(per)


def pair_rank_loss(a, b, label, *, margin: float = 1.0) -> torch.Tensor:
    """Margin ranking plus similarity hinge over paired scores:
    mean_i[max(0, margin - label_i (a_i - b_i)) + |(1 - label_i)(a_i - b_i)|]
    (PairRankLoss; margin 1 by default)."""
    diff = a - b
    ordered = _relu(margin - label * diff)
    similar = _abs((1.0 - label) * diff)
    return torch.mean(ordered + similar)


def sigmoid_cross_entropy(logits, targets) -> torch.Tensor:
    """SigmoidCrossEntropyLoss: summed over features, mean over the batch."""
    per = _relu(logits) - logits * targets + torch.log1p(
        torch.exp(-_abs(logits)))
    return torch.sum(per) / logits.shape[0]


def euclidean_loss(a, b) -> torch.Tensor:
    """EuclideanLoss: sum((a - b)^2) / (2N)."""
    d = a - b
    return torch.sum(d * d) / (2.0 * a.shape[0])


def hinge_loss(scores, labels, *, norm: str = "L1") -> torch.Tensor:
    """HingeLoss over (N, C) scores and int labels: max(0, 1 + s_c) for the
    wrong classes, max(0, 1 - s_y) for the right one, summed (squared for
    ``norm="L2"``) and divided by N."""
    n, c = scores.shape
    onehot = labels.to(torch.int64)[:, None] == torch.arange(
        c, device=scores.device)          # all False off [0, C), as one_hot
    sign = torch.where(onehot, -1.0, 1.0).to(scores.dtype)
    margins = _relu(1.0 + sign * scores)
    if norm == "L2":
        return torch.sum(margins * margins) / n
    return torch.sum(margins) / n


def multinomial_logistic_loss(probs, labels) -> torch.Tensor:
    """MultinomialLogisticLoss over probabilities:
    -mean_i log(max(p[i, y_i], 1e-20))."""
    p = _pick(probs, labels)
    return -torch.mean(torch.log(torch.maximum(
        p, torch.full_like(p, _KLOG_THRESHOLD))))


def infogain_loss(probs, labels, infogain) -> torch.Tensor:
    """InfogainLoss: -mean_i sum_j H[y_i, j] log(max(p[i, j], 1e-20)) with
    a (C, C) information-gain matrix H (the identity gives
    ``multinomial_logistic_loss``)."""
    h_rows = infogain[labels.to(torch.int64)]
    logp = torch.log(torch.maximum(probs,
                                   torch.full_like(probs, _KLOG_THRESHOLD)))
    return -torch.mean(torch.sum(h_rows * logp, dim=-1))


def contrastive_loss(a, b, y, *, margin: float = 1.0,
                     legacy: bool = False) -> torch.Tensor:
    """ContrastiveLoss: similar pairs (y = 1) pull by the squared distance,
    dissimilar ones push to the margin, max(margin - d, 0)^2, or with
    ``legacy`` max(margin - d^2, 0); summed and divided by 2N."""
    d2 = torch.sum((a - b) ** 2, dim=1)
    if legacy:
        push = _relu(margin - d2)
    else:
        d = torch.sqrt(torch.maximum(d2, torch.full_like(d2, 1e-12)))
        push = _relu(margin - d) ** 2
    per = y * d2 + (1.0 - y) * push
    return torch.sum(per) / (2.0 * a.shape[0])
