"""Parameter initializers (counterpart of ``utils/fillers.py``).

Randomness comes from an explicit ``torch.Generator``.  Values are drawn on
the generator's device and then moved to ``device``, so a CPU generator
gives the same weights whichever device they end up on.  The draws differ
from ``jax.random`` for the same seed; parity tests hand both packages the
same numpy weights instead (``convert.py``).
"""

from __future__ import annotations

import torch


def uniform(generator: torch.Generator, shape, minval: float, maxval: float,
            *, device=None) -> torch.Tensor:
    """float32 uniform(minval, maxval) of ``shape``."""
    x = torch.rand(tuple(shape), generator=generator, device=generator.device)
    x = x * (maxval - minval) + minval
    return x.to(device) if device is not None else x


def xavier(generator: torch.Generator, shape, fan_in: int | None = None, *,
           device=None) -> torch.Tensor:
    """Caffe-style Xavier: uniform(-s, s), s = sqrt(3 / fan_in).

    ``fan_in`` defaults to count / shape[0], as the reference's filler does.
    """
    scale = (3.0 / float(fan_in or _fan_in(shape))) ** 0.5
    return uniform(generator, shape, -scale, scale, device=device)


def _fan_in(shape) -> int:
    """count / shape[0], the reference's default FAN_IN."""
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    return fan_in


def gaussian(generator: torch.Generator, shape, mean: float = 0.0,
             std: float = 1.0, *, device=None) -> torch.Tensor:
    """float32 normal(mean, std) of ``shape``."""
    x = mean + std * torch.randn(tuple(shape), generator=generator,
                                 device=generator.device)
    return x.to(device) if device is not None else x


def constant(shape, value: float = 0.0, *, device=None) -> torch.Tensor:
    """``shape`` filled with ``value`` (the reference's default filler)."""
    return torch.full(tuple(shape), float(value), device=device)


def msra(generator: torch.Generator, shape, fan_in: int | None = None, *,
         device=None) -> torch.Tensor:
    """MSRA: normal(0, sqrt(2 / fan_in)), fan_in = count / shape[0] by
    default, as for Xavier."""
    std = (2.0 / float(fan_in or _fan_in(shape))) ** 0.5
    return gaussian(generator, shape, 0.0, std, device=device)


def positive_unitball(generator: torch.Generator, shape, *,
                      device=None) -> torch.Tensor:
    """uniform(0, 1), each leading-axis slice normalized to sum to 1."""
    x = uniform(generator, shape, 0.0, 1.0, device=device)
    flat = x.reshape(shape[0], -1)
    return (flat / torch.sum(flat, dim=1, keepdim=True)).reshape(tuple(shape))


def bilinear(shape, *, device=None) -> torch.Tensor:
    """The Deconvolution upsampling kernel f(y) f(x) over the last two axes
    (kh, kw), written into every leading slice."""
    def kern(k: int) -> torch.Tensor:
        f = (k + 1) // 2
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(k, dtype=torch.float32, device=device)
        return 1.0 - torch.abs(i / f - c)

    k2d = kern(shape[-2])[:, None] * kern(shape[-1])[None, :]
    return torch.broadcast_to(k2d, tuple(shape)).contiguous()
