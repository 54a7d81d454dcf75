"""Max / average pooling with Caffe's ceil-mode sizing, and the generic
net's padded, stochastic and pyramid pooling (counterpart of
``ops/pooling.py``).

pooled = ceil((H - k) / stride) + 1, and AVE divides each window by the
number of input elements it actually covers.  PyTorch's own ``ceil_mode``
drops a last window that would start past the input, which Caffe (with no
padding) keeps, so the sizing is done here explicitly: the input is padded
at its trailing edge to exactly cover the pooled grid, then pooled without
ceil mode.  NHWC in and out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _out_size(size: int, k: int, s: int) -> int:
    return int(math.ceil((size - k) / s)) + 1


def _pad_amount(size: int, k: int, s: int) -> int:
    return max(0, (_out_size(size, k, s) - 1) * s + k - size)


def _window_counts(size: int, k: int, s: int, like: torch.Tensor):
    """Input elements each window covers, in ``like``'s dtype on its
    device: computed there, so a captured CUDA graph holds no copy from
    the host."""
    starts = torch.arange(_out_size(size, k, s), device=like.device) * s
    return (torch.clamp(starts + k, max=size) - starts).to(like.dtype)


def max_pool2d(x: torch.Tensor, kh: int, kw: int, *, stride_h: int = 1,
               stride_w: int = 1) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H', W', C); windows clipped at the edge."""
    ph = _pad_amount(x.shape[1], kh, stride_h)
    pw = _pad_amount(x.shape[2], kw, stride_w)
    xc = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), value=-math.inf)
    y = F.max_pool2d(xc, (kh, kw), (stride_h, stride_w))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, kh: int, kw: int, *, stride_h: int = 1,
               stride_w: int = 1) -> torch.Tensor:
    """Average pooling that divides by the true element count of each
    (clipped) window."""
    h, w = x.shape[1], x.shape[2]
    ph = _pad_amount(h, kh, stride_h)
    pw = _pad_amount(w, kw, stride_w)
    xc = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph))
    sums = F.avg_pool2d(xc, (kh, kw), (stride_h, stride_w),
                        divisor_override=1)
    counts = _window_counts(h, kh, stride_h, x)[:, None] \
        * _window_counts(w, kw, stride_w, x)[None, :]
    return (sums / counts).permute(0, 2, 3, 1)


def _window_patches(x: torch.Tensor, kh: int, kw: int, sh: int,
                    sw: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, PH, PW, C, kh*kw) window patches with ceil-mode
    sizing, zero-padded past the trailing edge, window elements in the
    reference's row-major (h, w) order."""
    pad_h = _pad_amount(x.shape[1], kh, sh)
    pad_w = _pad_amount(x.shape[2], kw, sw)
    xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    p = xp.unfold(1, kh, sh).unfold(2, kw, sw)       # (N, PH, PW, C, kh, kw)
    return p.reshape(p.shape[:4] + (kh * kw,))


def stochastic_pool2d(x: torch.Tensor, kh: int, kw: int, *,
                      stride_h: int = 1, stride_w: int = 1,
                      generator: torch.Generator | None = None,
                      train: bool = True) -> torch.Tensor:
    """Stochastic pooling (the reference's STOCHASTIC mode, GPU-only there).

    Train: per window, the first element whose running sum reaches
    U[0, 1) x the window's sum (inputs assumed non-negative); the gradient
    goes to that element alone.  Test: sum(x^2) / (FLT_MIN + sum(x)).
    Padding is not supported, as in the reference's kernels."""
    patches = _window_patches(x, kh, kw, stride_h, stride_w)
    if not train:
        total = torch.sum(patches, dim=-1)
        sq = torch.sum(patches * patches, dim=-1)
        return sq / (float(np.finfo(np.float32).tiny) + total)
    if generator is None:
        raise ValueError("stochastic_pool2d(train=True) needs a generator")
    cum = torch.cumsum(patches, dim=-1)
    total = cum[..., -1:]
    u = torch.rand(total.shape, generator=generator,
                   device=generator.device).to(x.device, x.dtype)
    sel = torch.argmax((cum >= u * total.detach()).to(torch.int8), dim=-1)
    onehot = F.one_hot(sel, kh * kw).to(x.dtype)
    return torch.sum(patches * onehot, dim=-1)


def pool2d_padded(x: torch.Tensor, kh: int, kw: int, *, stride_h: int,
                  stride_w: int, pad_h: int = 0, pad_w: int = 0,
                  mode: str = "max") -> torch.Tensor:
    """Caffe pooling with explicit symmetric padding: pooled =
    ceil((H + 2*pad - k)/s) + 1, less one where the last window would start
    in the padding.  MAX ignores padded cells; AVE sums the real cells and
    divides by the window's overlap with the padded extent."""
    h, w = x.shape[1], x.shape[2]

    def sizes(size, k, s, p):
        pooled = int(math.ceil((size + 2 * p - k) / s)) + 1
        # the reference checks the last window on both axes when either
        # axis is padded
        if (pad_h or pad_w) and (pooled - 1) * s >= size + p:
            pooled -= 1
        return pooled

    ph_out = sizes(h, kh, stride_h, pad_h)
    pw_out = sizes(w, kw, stride_w, pad_w)
    end_h = max(0, (ph_out - 1) * stride_h + kh - h - pad_h)
    end_w = max(0, (pw_out - 1) * stride_w + kw - w - pad_w)
    xc = x.permute(0, 3, 1, 2)
    if mode == "max":
        xc = F.pad(xc, (pad_w, end_w, pad_h, end_h), value=-math.inf)
        y = F.max_pool2d(xc, (kh, kw), (stride_h, stride_w))
        return y.permute(0, 2, 3, 1)
    if mode != "ave":
        raise ValueError(mode)
    xc = F.pad(xc, (pad_w, end_w, pad_h, end_h))
    sums = F.avg_pool2d(xc, (kh, kw), (stride_h, stride_w),
                        divisor_override=1)

    def counts(size, k, s, p, pooled):
        # built on the device: a host copy cannot be captured in a graph
        starts = torch.arange(pooled, device=x.device) * s - p
        ends = torch.clamp(starts + k, max=size + p)
        return (ends - starts).to(x.dtype)

    count = torch.outer(counts(h, kh, stride_h, pad_h, ph_out),
                        counts(w, kw, stride_w, pad_w, pw_out))
    return (sums / count).permute(0, 2, 3, 1)


def spatial_pyramid_pool(x: torch.Tensor, pyramid_height: int, *,
                         mode: str = "max") -> torch.Tensor:
    """SPP: level l pools to a 2^l x 2^l grid (kernel = ceil(dim / bins),
    stride = kernel, pad = (kernel * bins - dim + 1) // 2), each level
    flattened channel-major (the reference's NCHW order), levels
    concatenated: (N, H, W, C) -> (N, C * sum(4^l))."""
    n, h, w, _ = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        kh = int(math.ceil(h / bins))
        kw = int(math.ceil(w / bins))
        pooled = pool2d_padded(x, kh, kw, stride_h=kh, stride_w=kw,
                               pad_h=(kh * bins - h + 1) // 2,
                               pad_w=(kw * bins - w + 1) // 2, mode=mode)
        outs.append(pooled.permute(0, 3, 1, 2).reshape(n, -1))
    return torch.cat(outs, dim=1)
