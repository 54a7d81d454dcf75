"""The reference's BN-v0 layer (counterpart of ``ops/batch_norm.py``).

It differs from ``nn.BatchNorm2d`` on three points, all kept here: eps
1e-9 is added to the variance, the variance is the biased E[x^2]-E[x]^2,
and the running statistics move by an EMA of 0.9 inside the training
forward."""

from __future__ import annotations

import torch
import torch.distributed as dist

VAR_EPS = 1e-9
DEFAULT_MOMENTUM = 0.9
MOMENTUM = DEFAULT_MOMENTUM  # the name this package used first


def bn_init(channels: int, *, scale_value: float = 1.0,
            shift_value: float = 1e-3, dtype=torch.float32, device=None):
    """Returns (params, state) for one BN layer: the given scale and shift
    (the QA recipe's fillers by default: scale 1, shift 1e-3), running mean
    and variance 0."""
    kw = {"dtype": dtype, "device": device}
    params = {"scale": torch.full((channels,), scale_value, **kw),
              "shift": torch.full((channels,), shift_value, **kw)}
    state = {"mean": torch.zeros((channels,), **kw),
             "var": torch.zeros((channels,), **kw)}
    return params, state


def bn_apply(params, state, x: torch.Tensor, *, train: bool,
             momentum: float = DEFAULT_MOMENTUM, eps: float = VAR_EPS,
             group=None):
    """BN over an NHWC (or N...C) tensor with per-trailing-channel stats.
    Returns (y, new_state); in eval mode new_state is ``state``.
    ``momentum`` is the EMA's memory (the BN layer's ``bn_memory``);
    ``eps`` is added to the variance.

    ``group``: a process group whose ranks each hold an equal share of the
    batch; the training statistics are then the whole batch's (the sums
    all-reduced, with a backward), as the JAX package's under a
    dp-sharded ``jit``."""
    dims = tuple(range(x.ndim - 1))
    if train and group is not None:
        from ..parallel.collectives import all_reduce_sum
        n = x.numel() // x.shape[-1] * dist.get_world_size(group)
        sums = all_reduce_sum(torch.stack([torch.sum(x, dim=dims),
                                           torch.sum(x * x, dim=dims)]),
                              group)
        mu = sums[0] / n
        var = sums[1] / n - mu * mu
    elif train:
        mu = torch.mean(x, dim=dims)
        var = torch.mean(x * x, dim=dims) - mu * mu
    if train:
        new_state = {
            "mean": (1.0 - momentum) * mu.detach() + momentum * state["mean"],
            "var": (1.0 - momentum) * var.detach() + momentum * state["var"],
        }
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps)
    y = (x - mu) * (inv * params["scale"]) + params["shift"]
    return y, new_state
