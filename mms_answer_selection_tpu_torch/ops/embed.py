"""Embedding lookup and pretrained-vector loading (counterpart of
``ops/embed.py``)."""

from __future__ import annotations

import numpy as np
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
