"""Inverted dropout (counterpart of ``ops/dropout.py``): a Bernoulli keep
mask scaled by 1/(1-ratio) when training, the identity otherwise."""

from __future__ import annotations

import torch


def dropout(generator: torch.Generator, x: torch.Tensor, ratio: float, *,
            train: bool, shard: tuple[int, int] | None = None) -> torch.Tensor:
    """``shard``: (index, count) when ``x`` is rows [index * N, (index + 1)
    * N) of a batch split over ``count`` ranks: the whole batch's mask is
    drawn and this rank's rows taken, so the split draws what one rank
    drawing for the whole batch draws."""
    if not train or ratio <= 0.0:
        return x
    keep = 1.0 - ratio
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    else:
        index, count = shard
        n = x.shape[0]
        u = torch.rand((n * count,) + tuple(x.shape[1:]),
                       generator=generator,
                       device=generator.device)[index * n:(index + 1) * n]
    mask = u.to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
