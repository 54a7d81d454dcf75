"""Embedding lookup (counterpart of ``ops/embed.py``)."""

from __future__ import annotations

import torch

from ..utils import fillers


def embed_init(generator: torch.Generator, vocab_size: int, dim: int, *,
               pretrained=None, minval: float = -0.08, maxval: float = 0.08,
               bias_term: bool = True, device=None):
    """Returns {'w': (V, D) uniform(minval, maxval)[, 'b': (D,) zeros]}.

    ``pretrained``: optional (n, D) array written into rows [0, n), the
    reference's weight_source semantics (the data prep puts the pretrained
    vectors first, in vocab order; the unknown and pad rows stay random).
    """
    w = fillers.uniform(generator, (vocab_size, dim), minval, maxval,
                        device=device)
    if pretrained is not None:
        pretrained = torch.as_tensor(pretrained, dtype=w.dtype)
        if pretrained.ndim != 2 or pretrained.shape[1] != dim:
            raise ValueError(f"pretrained dim {tuple(pretrained.shape)[1:]} "
                             f"!= embed dim {dim}")
        if pretrained.shape[0] > vocab_size:
            raise ValueError("more pretrained rows than vocab entries")
        w[: pretrained.shape[0]] = pretrained.to(w.device)
    params = {"w": w}
    if bias_term:
        params["b"] = torch.zeros((dim,), device=w.device)
    return params


def embed_lookup(params, ids: torch.Tensor) -> torch.Tensor:
    """ids: int (..., W) -> (..., W, D), plus the shared bias if present.

    Out-of-range ids clamp into [0, V-1], as ``jnp.take(mode="clip")``
    does in the reference."""
    w = params["w"]
    ids = ids.to(device=w.device, dtype=torch.int64).clamp(0, w.shape[0] - 1)
    out = w[ids]
    if "b" in params:
        out = out + params["b"]
    return out
