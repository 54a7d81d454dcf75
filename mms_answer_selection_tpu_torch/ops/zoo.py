"""Stock layer zoo: the reference's generic layer vocabulary as PyTorch ops
(counterpart of ``ops/zoo.py``).

The functions pin down the layers whose *semantics* are not a one-line
torch call (exact parameterizations cited per function); the structural
layers (Flatten / Reshape / Concat / Slice / Split / Tile / Crop) are
tensor built-ins in ``models/graph_net.py``.  Everything is a pure
function on NHWC (or N...C) tensors; the learnable variants (PReLU,
Scale) take their parameter explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .losses import _abs

# ----------------------------------------------------------------- neurons


def relu(x, *, negative_slope: float = 0.0):
    """ReLULayer with leaky slope (relu_layer.cpp; negative_slope param)."""
    return torch.where(x > 0, x, negative_slope * x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def elu(x, *, alpha: float = 1.0):
    """ELULayer: x if x>0 else alpha*(exp(x)-1) (elu_layer.cpp)."""
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def prelu(x, slopes, *, channel_axis: int = -1):
    """PReLULayer: per-channel learnable negative slopes (prelu_layer.cpp;
    channel_shared collapses slopes to one)."""
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    return torch.where(x > 0, x, torch.reshape(slopes, shape) * x)


def bnll(x):
    """BNLLLayer: log(1 + exp(x)), in the overflow-safe split form."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-_abs(x)))


def power(x, *, power: float = 1.0, scale: float = 1.0, shift: float = 0.0):
    """PowerLayer: (shift + scale*x)^power (power_layer.cpp)."""
    return (shift + scale * x) ** power


def exp(x, *, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    """ExpLayer: base^(shift + scale*x); base=-1 means e (exp_layer.cpp)."""
    y = shift + scale * x
    return torch.exp(y) if base <= 0 else torch.pow(base, y)


def log(x, *, base: float = -1.0, scale: float = 1.0, shift: float = 0.0):
    """LogLayer: log_base(shift + scale*x) (log_layer.cpp)."""
    y = torch.log(shift + scale * x)
    return y if base <= 0 else y / torch.log(torch.tensor(base, dtype=y.dtype))


def threshold(x, *, threshold: float = 0.0):
    """ThresholdLayer: 1 if x > t else 0 (threshold_layer.cpp)."""
    return (x > threshold).to(x.dtype)


def absval(x):
    """AbsValLayer, with the gradient +1 at 0 that ``jnp.abs`` has."""
    return _abs(x)


# ------------------------------------------------------------ normalization


def mvn(x, *, normalize_variance: bool = True, across_channels: bool = False,
        eps: float = 1e-9, channel_axis: int = -1):
    """MVNLayer: per-sample mean (and optionally variance) normalization
    (mvn_layer.cpp), dividing by stddev + eps as the reference does."""
    dims = tuple(i for i in range(1, x.ndim)
                 if across_channels or i != (channel_axis % x.ndim))
    y = x - torch.mean(x, dim=dims, keepdim=True)
    if normalize_variance:
        std = torch.sqrt(torch.mean(y * y, dim=dims, keepdim=True))
        y = y / (std + eps)
    return y


def lrn_across_channels(x, *, local_size: int = 5, alpha: float = 1.0,
                        beta: float = 0.75, k: float = 1.0):
    """LRNLayer ACROSS_CHANNELS over NHWC (lrn_layer.cpp):
    y = x / (k + alpha/n * sum_window x^2)^beta."""
    c = x.shape[-1]
    pad = local_size // 2
    padded = F.pad(x * x, (pad, pad))
    window = sum(padded[..., i: i + c] for i in range(local_size))
    return x / (k + (alpha / local_size) * window) ** beta


def lrn_within_channel(x, *, local_size: int = 5, alpha: float = 1.0,
                       beta: float = 0.75):
    """LRNLayer WITHIN_CHANNEL over NHWC (lrn_layer.cpp:17-67):
    y = x * (1 + alpha * avepool(x^2))^-beta, an AVE pool of kernel
    local_size, stride 1, pad (local_size-1)/2.  As in the reference, ``k``
    is ignored in this mode and alpha is not divided by the window size."""
    if local_size % 2 != 1:
        raise ValueError("LRN only supports odd local_size "
                         "(lrn_layer.cpp:12 CHECKs the same)")
    from .pooling import pool2d_padded
    pre_pad = (local_size - 1) // 2
    pooled = pool2d_padded(x * x, local_size, local_size, stride_h=1,
                           stride_w=1, pad_h=pre_pad, pad_w=pre_pad,
                           mode="ave")
    return x * (1.0 + alpha * pooled) ** (-beta)


def scale(x, scale_param, bias_param=None, *, channel_axis: int = -1):
    """ScaleLayer (+ fused bias): per-channel learned multiplier."""
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    y = x * torch.reshape(scale_param, shape)
    if bias_param is not None:
        y = y + torch.reshape(bias_param, shape)
    return y


# ------------------------------------------------------------- convolution


def deconv2d(x, weight, bias=None, *, stride: int = 1, pad: int = 0,
             dilation: int = 1, group: int = 1):
    """DeconvolutionLayer (deconv_layer.cpp): output size
    ``stride*(in-1) + dilation*(k-1) + 1 - 2*pad``.

    x: (N, H, W, Cin) NHWC.  weight: the reference's blob layout
    (Cin, Cout//group, kh, kw), which is also ``conv_transpose2d``'s, so a
    reference .caffemodel deconv blob drops in unchanged.  Full float32
    (no TF32), as the reference accumulates."""
    cin = weight.shape[0]
    if x.shape[-1] != cin:
        raise ValueError(f"x channels {x.shape[-1]} != weight Cin {cin}")
    if cin % group:
        raise ValueError(f"Cin {cin} not divisible by group {group}")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias,
                               stride=stride, padding=pad, groups=group,
                               dilation=dilation)
    return y.permute(0, 2, 3, 1)


# -------------------------------------------------------------- reductions


def eltwise(inputs, *, operation: str = "sum", coeffs=None):
    """EltwiseLayer: PROD / SUM (with coeffs) / MAX (eltwise_layer.cpp)."""
    if operation == "prod":
        out = inputs[0]
        for x in inputs[1:]:
            out = out * x
        return out
    if operation == "sum":
        if coeffs and len(coeffs) != len(inputs):
            raise ValueError(f"Eltwise SUM got {len(coeffs)} coeffs for "
                             f"{len(inputs)} bottoms")
        coeffs = coeffs or [1.0] * len(inputs)
        out = coeffs[0] * inputs[0]
        for c, x in zip(coeffs[1:], inputs[1:]):
            out = out + c * x
        return out
    if operation == "max":
        out = inputs[0]
        for x in inputs[1:]:
            out = torch.maximum(out, x)
        return out
    raise ValueError(operation)


def reduction(x, *, operation: str = "sum", axis: int = 0,
              coeff: float = 1.0, axes=None):
    """ReductionLayer: SUM/ASUM/SUMSQ/MEAN over the trailing axes from
    ``axis`` (reduction_layer.cpp), or over ``axes`` when given (the
    caller maps layouts)."""
    if axes is None:
        a = axis % x.ndim if x.ndim else 0
        axes = tuple(range(a, x.ndim)) if x.ndim > a else ()
    else:
        axes = tuple(axes)
    if operation == "sum":
        r = torch.sum(x, dim=axes)
    elif operation == "asum":
        r = torch.sum(_abs(x), dim=axes)
    elif operation == "sumsq":
        r = torch.sum(x * x, dim=axes)
    elif operation == "mean":
        r = torch.mean(x, dim=axes)
    else:
        raise ValueError(operation)
    return coeff * r


def argmax(x, *, top_k: int = 1, out_max_val: bool = False,
           axis: int | None = None):
    """ArgMaxLayer (argmax_layer.cpp): with ``axis``, top-k along it, the k
    dim replacing it (values with ``out_max_val``, else float indices);
    without, per row over the flattened trailing dims: (N, 1, k) indices,
    or (N, 2, k) indices then values with ``out_max_val``."""
    if axis is not None:
        vals, idx = torch.topk(torch.movedim(x, axis, -1), top_k)
        out = vals if out_max_val else idx.to(torch.float32)
        return torch.movedim(out, -1, axis % x.ndim)
    vals, idx = torch.topk(x.reshape(x.shape[0], -1), top_k)
    idxf = idx.to(torch.float32)[:, None, :]
    if out_max_val:
        return torch.cat([idxf, vals[:, None, :]], dim=1)
    return idxf


def accuracy(scores, labels, *, top_k: int = 1,
             ignore_label: int | None = None):
    """AccuracyLayer (accuracy_layer.cpp): the fraction of rows whose label
    is among the top-k scores, ``ignore_label`` rows left out."""
    _, idx = torch.topk(scores, top_k)
    hit = torch.any(idx == labels[:, None].to(idx.dtype),
                    dim=1).to(torch.float32)
    if ignore_label is not None:
        valid = (labels != ignore_label).to(torch.float32)
        return torch.sum(hit * valid) / torch.clamp(torch.sum(valid), min=1.0)
    return torch.mean(hit)


def batch_reindex(x, permutation):
    """BatchReindexLayer: gather rows (batch_reindex_layer.cpp)."""
    return torch.index_select(x, 0, permutation.to(x.device, torch.int64))


def filter_rows(x, selector, *, capacity: int | None = None):
    """FilterLayer (filter_layer.cpp:15-67): keep the rows whose selector
    entry is nonzero, in input order, compacted to the front of a
    fixed-``capacity`` result (default: the whole batch) whose rows at and
    past the true count are zero; returns (filtered, count) as the JAX
    package's padded form does.  A tuple of tensors filters several
    bottoms by one selector."""
    multi = isinstance(x, (tuple, list))
    xs = tuple(x) if multi else (x,)
    keep = torch.reshape(torch.as_tensor(selector), (-1,)) != 0
    keep = keep.to(xs[0].device)
    n = keep.shape[0]
    cap = n if capacity is None else capacity
    order = torch.argsort(torch.logical_not(keep).to(torch.int8),
                          stable=True)[:cap]
    count = torch.clamp(torch.sum(keep.to(torch.int32)), max=cap)
    valid = torch.arange(cap, device=keep.device) < count

    def one(a):
        y = torch.index_select(a, 0, order)
        mask = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(mask, y, torch.zeros((), dtype=a.dtype,
                                                device=a.device))

    out = tuple(one(a) for a in xs)
    return (out if multi else out[0]), count


def filter_reduce(x, selector, *, operation: str = "mean"):
    """Reduce over only the rows FilterLayer would keep (sum | mean | max):
    Filter -> Reduction without the compaction.  An all-zero selector gives
    0 for sum and mean and the dtype's lowest value for max."""
    keep = torch.reshape(torch.as_tensor(selector), (-1,)).to(x.device) != 0
    mask = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    if operation == "sum":
        return torch.sum(torch.where(mask, x, 0), dim=0)
    if operation == "mean":
        n = torch.clamp(torch.sum(keep.to(x.dtype)), min=1)
        return torch.sum(torch.where(mask, x, 0), dim=0) / n
    if operation == "max":
        lowest = torch.finfo(x.dtype).min if x.dtype.is_floating_point \
            else torch.iinfo(x.dtype).min
        return torch.amax(torch.where(mask, x, lowest), dim=0)
    raise ValueError(operation)
