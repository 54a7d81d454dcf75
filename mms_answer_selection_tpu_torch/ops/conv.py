"""2-D convolution, NHWC in and out (counterpart of ``ops/conv.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import fillers


def conv_init(generator: torch.Generator, in_channels: int,
              out_channels: int, kh: int, kw: int, *,
              bias_value: float = 0.0, dtype=torch.float32, device=None):
    """Returns {'w': (kh, kw, Cin, Cout) HWIO xavier, 'b': (Cout,) filled
    with ``bias_value``}."""
    w = fillers.xavier(generator, (kh, kw, in_channels, out_channels),
                       fan_in=in_channels * kh * kw, device=device,
                       dtype=dtype)
    return {"w": w, "b": torch.full((out_channels,), float(bias_value),
                                    dtype=dtype, device=w.device)}


def _f32():
    """cuDNN at full float32: it would run a float32 convolution in TF32 by
    default, where the reference accumulates at full float32
    (``Precision.HIGHEST``)."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _pair(v) -> list:
    return [int(v), int(v)] if isinstance(v, int) else [int(a) for a in v]


class _ConvF32(torch.autograd.Function):
    """``aten.convolution`` and its backward, both with TF32 off: the
    backward kernels read cuDNN's flags when the backward runs, outside any
    ``with`` around the forward."""

    @staticmethod
    def forward(ctx, x, w, b, *args):
        ctx.save_for_backward(x, w)
        ctx.args = args
        ctx.bias = None if b is None else list(b.shape)
        with _f32():
            return torch.ops.aten.convolution(x, w, b, *args)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with _f32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, ctx.bias, *ctx.args,
                [need[0], need[1], need[2] and ctx.bias is not None])
        return (gx, gw, gb) + (None,) * len(ctx.args)


def conv_f32(x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
             transposed: bool = False):
    """An NCHW (transposed) convolution whose forward and backward both
    run at full float32 on cuDNN; the same aten kernels as ``F.conv2d`` /
    ``F.conv_transpose2d`` otherwise.  Without a gradient to take it is a
    plain operator call, which ``torch.export`` traces."""
    args = (_pair(stride), _pair(padding), _pair(dilation), transposed,
            [0, 0], int(groups))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _ConvF32.apply(x, w, b, *args)
    with _f32():
        return torch.ops.aten.convolution(x, w, b, *args)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME": the output is ceil(size / stride) long, and of an odd
    total pad the extra row goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params, x: torch.Tensor, *, stride: int = 1,
           padding="VALID") -> torch.Tensor:
    """x: (N, H, W, Cin) -> (N, H', W', Cout).  ``padding`` is "VALID"
    (the default, the QA recipes' pad 0), "SAME" (XLA's rule) or explicit
    ((top, bottom), (left, right)) pads, as ``lax.conv_general_dilated``
    takes them.  Full float32 forward and backward (``conv_f32``),
    whatever cuDNN's global TF32 flag says."""
    w = params["w"]
    kh, kw = int(w.shape[0]), int(w.shape[1])
    x = x.permute(0, 3, 1, 2)
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pads = (_same_pads(x.shape[2], kh, stride),
                    _same_pads(x.shape[3], kw, stride))
        elif padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, "
                             f"got {padding!r}")
    else:
        pads = tuple((int(a), int(b)) for a, b in padding)
    (t, b), (l, r) = pads
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    y = conv_f32(x, w.permute(3, 2, 0, 1), stride=stride)  # HWIO -> OIHW
    return y.permute(0, 2, 3, 1) + params["b"]
