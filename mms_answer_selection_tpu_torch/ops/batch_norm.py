"""The reference's BN-v0 layer (counterpart of ``ops/batch_norm.py``).

It differs from ``nn.BatchNorm2d`` on three points, all kept here: eps
1e-9 is added to the variance, the variance is the biased E[x^2]-E[x]^2,
and the running statistics move by an EMA of 0.9 inside the training
forward."""

from __future__ import annotations

import torch

VAR_EPS = 1e-9
MOMENTUM = 0.9


def bn_init(channels: int, *, shift_value: float, device=None):
    """Returns (params, state) for one BN layer: scale 1, the given shift,
    running mean and variance 0."""
    params = {"scale": torch.ones((channels,), device=device),
              "shift": torch.full((channels,), shift_value, device=device)}
    state = {"mean": torch.zeros((channels,), device=device),
             "var": torch.zeros((channels,), device=device)}
    return params, state


def bn_apply(params, state, x: torch.Tensor, *, train: bool,
             momentum: float = MOMENTUM):
    """BN over an NHWC (or N...C) tensor with per-trailing-channel stats.
    Returns (y, new_state); in eval mode new_state is ``state``.
    ``momentum`` is the EMA's memory (the BN layer's ``bn_memory``)."""
    dims = tuple(range(x.ndim - 1))
    if train:
        mu = torch.mean(x, dim=dims)
        var = torch.mean(x * x, dim=dims) - mu * mu
        new_state = {
            "mean": (1.0 - momentum) * mu.detach() + momentum * state["mean"],
            "var": (1.0 - momentum) * var.detach() + momentum * state["var"],
        }
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + VAR_EPS)
    y = (x - mu) * (inv * params["scale"]) + params["shift"]
    return y, new_state
