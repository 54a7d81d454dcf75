"""Embedding lookup, the table's gradient and pretrained-vector loading
(counterpart of ``ops/embed.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import fillers
from . import sim_cross_kernels as sk


def embed_init(generator: torch.Generator, vocab_size: int, dim: int, *,
               pretrained=None, minval: float = -0.08, maxval: float = 0.08,
               bias_term: bool = True, dtype=torch.float32, device=None):
    """Returns {'w': (V, D) uniform(minval, maxval)[, 'b': (D,) zeros]}.

    ``pretrained``: optional (n, D) array written into rows [0, n), the
    reference's weight_source semantics (the data prep puts the pretrained
    vectors first, in vocab order; the unknown and pad rows stay random).
    """
    w = fillers.uniform(generator, (vocab_size, dim), minval, maxval,
                        device=device, dtype=dtype)
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
        params["b"] = torch.zeros((dim,), dtype=dtype, device=w.device)
    return params


# positions a block of csrc/embed_grad.cu's first pass takes, which sizes
# the scratch below; the kernel is built for this tile and refuses another
_TILE = 256


def embed_grad(ids: torch.Tensor, g: torch.Tensor,
               vocab_size: int) -> torch.Tensor:
    """The table's gradient (V, D) float32 for ids (T,) int64 already
    clamped into [0, V) and g = dL/dout (T, D) float32, on one card: the
    ``embed_grad`` kernel, each id's rows of g summed in a fixed order (two
    runs give the same bits), zero rows elsewhere."""
    if sk._on_cpu(ids, g):
        raise ValueError("embed_grad takes CUDA tensors; on the CPU the "
                         "lookup keeps the autograd of w[ids]")
    ids, g = ids.contiguous(), g.contiguous()
    sk._check_cuda_operands(align=8, ids=(ids, torch.int64))
    sk._check_cuda_operands(align=4, g=(g, torch.float32))
    t, d = g.shape
    if ids.shape != (t,) or not 0 < vocab_size < 2**31 - 1 \
            or t >= 2**31 - _TILE:
        raise ValueError(f"embed_grad: ids {tuple(ids.shape)}, g "
                         f"{tuple(g.shape)}, V={vocab_size}")
    tiles = -(-t // _TILE)
    out = torch.empty((vocab_size, d), dtype=torch.float32, device=g.device)
    part = torch.empty(tiles * _TILE * d, dtype=torch.float32,
                       device=g.device)
    meta = torch.empty(tiles * (_TILE + 1), dtype=torch.int32,
                       device=g.device)
    sk._launch("embed_grad", g, ids.data_ptr(), g.data_ptr(), out.data_ptr(),
               part.data_ptr(), meta.data_ptr(), t, d, vocab_size, _TILE)
    return out


class _EmbedLookup(torch.autograd.Function):
    """``w[ids]`` whose backward is ``embed_grad``."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.vocab_size = w.shape[0]
        return w[ids]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embed_grad(ids.reshape(-1), g.reshape(-1, g.shape[-1]),
                          ctx.vocab_size), None


def embed_lookup(params, ids: torch.Tensor) -> torch.Tensor:
    """ids: int (..., W) -> (..., W, D), plus the shared bias if present.

    Out-of-range ids clamp into [0, V-1], as ``jnp.take(mode="clip")``
    does in the reference.  A float32 table on a card that needs its
    gradient takes it from the ``embed_grad`` kernel; everywhere else the
    lookup is ``w[ids]`` with its own autograd."""
    w = params["w"]
    ids = ids.to(device=w.device, dtype=torch.int64).clamp(0, w.shape[0] - 1)
    if w.is_cuda and w.dtype == torch.float32 and w.requires_grad \
            and torch.is_grad_enabled():
        out = _EmbedLookup.apply(w, ids)
    else:
        out = w[ids]
    if "b" in params:
        out = out + params["b"]
    return out


def load_pretrained_vectors(path: str, dim: int) -> tuple[list[str], np.ndarray]:
    """Parse a ``.txt`` / ``.all`` / word2vec ``.bin`` pretrained-vector
    file (the fork's Embed ``weight_source``, embed_layer.cpp:46-110).

    Returns (words, (n, dim) float32 array) in file order, the order in
    which the reference writes them into the weight blob.
    """
    if path.endswith(".txt"):
        words, vecs = [], []
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < dim + 1:
                    continue
                words.append(parts[0])
                vecs.append(np.asarray(parts[1: dim + 1], dtype=np.float32))
        return words, np.stack(vecs) if vecs else np.zeros((0, dim), np.float32)
    if path.endswith(".all"):
        # header: bias vocab_size-1 dim-1; then "<index> <d floats> <word>"
        words, vecs = [], []
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            tokens = f.read().split()
        i = 3  # skip the header triple
        while i + dim + 2 <= len(tokens):
            vecs.append(np.asarray(tokens[i + 1: i + 1 + dim],
                                   dtype=np.float32))
            words.append(tokens[i + 1 + dim])
            i += dim + 2
        return words, np.stack(vecs) if vecs else np.zeros((0, dim), np.float32)
    # word2vec binary: "vocab dim\n" then (word + ' ' + dim float32s) records
    words, vecs = [], []
    with open(path, "rb") as f:
        header = f.readline().split()
        vocab_size, file_dim = int(header[0]), int(header[1])
        if file_dim != dim:
            raise ValueError(f"file dim {file_dim} != requested {dim}")
        for _ in range(vocab_size):
            chars = []
            while True:
                ch = f.read(1)
                if not ch or ch == b" ":
                    break
                if ch != b"\n":
                    chars.append(ch)
            words.append(b"".join(chars).decode("utf-8", errors="replace"))
            vecs.append(np.frombuffer(f.read(4 * dim), dtype=np.float32))
    return words, np.stack(vecs) if vecs else np.zeros((0, dim), np.float32)
