"""Word-by-word similarity maps (counterpart of ``ops/similarity.py``).

All return NHWC ``(N, W1, W2, M|1)``.  The cosine and inverse-euclidean
maps are plain products in the reference too (einsums outside any Pallas
kernel), so they stay ``torch.einsum`` here; on CUDA a float32 ``einsum``
runs in full float32 unless the caller has turned
``torch.backends.cuda.matmul.allow_tf32`` on.

The learned bilinear map computes what the reference's Pallas pair-map
kernel computes (its model calls the equivalent einsum, which ties with
the kernel on the TPU), so here it goes through ``bilinear_pair_maps``:
the hand-written forward and backward kernels on CUDA tensors, their plain
einsum versions on CPU tensors.
"""

from __future__ import annotations

import torch

from .sim_cross_kernels import bilinear_pair_maps


def sim_cross_inv_euclidean(q, a):
    """1 / (1 + ||q_i - a_j||); q: (N, W1, D), a: (N, W2, D)."""
    qq = torch.sum(q * q, dim=-1)
    aa = torch.sum(a * a, dim=-1)
    qa = torch.einsum("nid,njd->nij", q, a)
    d2 = qq[:, :, None] + aa[:, None, :] - 2.0 * qa
    out = 1.0 / (1.0 + torch.sqrt(torch.clamp(d2, min=0.0)))
    return out[..., None]


def sim_cross_cosine(q, a):
    """<q_i, a_j> / (||q_i|| ||a_j||), unguarded as in the reference."""
    qn = torch.sqrt(torch.sum(q * q, dim=-1))
    an = torch.sqrt(torch.sum(a * a, dim=-1))
    qa = torch.einsum("nid,njd->nij", q, a)
    return (qa / (qn[:, :, None] * an[:, None, :]))[..., None]


def sim_cross_bilinear(q, a, w, bias=None):
    """out[n, i, j, m] = q_i^T W_m a_j (+ bias[m, i, j]).

    q: (N, W1, D), a: (N, W2, D), w: (M, D, D), bias: (M, W1, W2) or None.
    """
    out = bilinear_pair_maps(q, a, w)
    if bias is not None:
        out = out + bias.permute(1, 2, 0)[None]
    return out
