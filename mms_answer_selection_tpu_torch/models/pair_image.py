"""Siamese image-pair metric model, the multimodal path of configs[4]
(counterpart of ``models/pair_image.py``).

A shared conv encoder (conv -> BN -> max-pool -> tanh blocks, the QA
model's block vocabulary) runs over img1 ++ img2 concatenated on the batch
axis, so both images see one set of BN batch statistics, as in the
reference; a linear head gives one score per image, and training uses
the margin-rank plus similarity-hinge loss (PairRankLoss).  NHWC images,
HWIO conv weights, the JAX package's parameter keys.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..metrics.ir_metrics import rank_accuracy_torch
from ..ops import bn_apply, bn_init, conv2d, conv_init, pair_rank_loss
from ..ops.pooling import _out_size, max_pool2d
from ..utils import fillers
from .mms_qa import ConvBlock

BN_SHIFT_INIT = 1e-3   # the JAX package's bn_init default (the QA recipe's)


@dataclasses.dataclass(frozen=True)
class PairImageConfig:
    height: int = 16
    width: int = 16
    channels: int = 1
    blocks: Sequence[ConvBlock] = (
        ConvBlock(3, 3, 8, "max", 2, 2),
        ConvBlock(3, 3, 16, "max", 2, 2),
    )
    fc_dim: int = 16
    margin: float = 1.0   # PairRankLossParameter.margin


def _spatial(cfg: PairImageConfig):
    h, w, c = cfg.height, cfg.width, cfg.channels
    for b in cfg.blocks:
        h, w = h - b.kh + 1, w - b.kw + 1
        h = _out_size(h, b.pool_k, b.pool_stride)
        w = _out_size(w, b.pool_k, b.pool_stride)
        c = b.out_channels
    return h, w, c


def conv_blocks_init(generator: torch.Generator, blocks, in_ch: int, *,
                     dtype=torch.float32, device=None):
    """xavier conv weights and BN (scale 1, shift 1e-3) for each block, in
    block order: (params, state, channels out)."""
    params, state = {}, {}
    for i, b in enumerate(blocks):
        params[f"conv{i}"] = conv_init(generator, in_ch, b.out_channels,
                                       b.kh, b.kw, dtype=dtype,
                                       device=device)
        params[f"bn{i}"], state[f"bn{i}"] = bn_init(
            b.out_channels, shift_value=BN_SHIFT_INIT, dtype=dtype,
            device=device)
        in_ch = b.out_channels
    return params, state, in_ch


def conv_blocks_apply(params, state, x, blocks, *, train: bool):
    """conv -> BN -> max-pool -> tanh for each block: (x, new_state)."""
    new_state = dict(state)
    for i, b in enumerate(blocks):
        x = conv2d(params[f"conv{i}"], x)
        x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"], state[f"bn{i}"],
                                          x, train=train)
        x = torch.tanh(max_pool2d(x, b.pool_k, b.pool_k,
                                  stride_h=b.pool_stride,
                                  stride_w=b.pool_stride))
    return x, new_state


def pair_image_init(cfg: PairImageConfig, *, generator: torch.Generator,
                    dtype=torch.float32, device=None):
    """(params, state) of ``dtype``, drawn from ``generator`` in the order
    conv blocks, fc, score."""
    params, state, _ = conv_blocks_init(generator, cfg.blocks, cfg.channels,
                                        dtype=dtype, device=device)
    kw = {"dtype": dtype, "device": device}
    h, w, c = _spatial(cfg)
    flat = h * w * c
    params["fc"] = {"w": fillers.xavier(generator, (flat, cfg.fc_dim),
                                        fan_in=flat, **kw),
                    "b": torch.zeros((cfg.fc_dim,), **kw)}
    params["score"] = {"w": fillers.xavier(generator, (cfg.fc_dim, 1),
                                           fan_in=cfg.fc_dim, **kw),
                       "b": torch.zeros((1,), **kw)}
    return params, state


def encode(params, state, x, cfg: PairImageConfig, *, train: bool):
    """Shared encoder: (N, H, W, C) -> ((N,) scalar scores, new_state)."""
    x, new_state = conv_blocks_apply(params, state, x, cfg.blocks,
                                     train=train)
    flat = x.reshape(x.shape[0], -1)                 # NHWC (h, w, c) order
    h = torch.tanh(flat @ params["fc"]["w"] + params["fc"]["b"])
    return (h @ params["score"]["w"] + params["score"]["b"])[:, 0], new_state


def pair_image_apply(params, state, batch, cfg: PairImageConfig, *,
                     train: bool, generator: torch.Generator | None = None):
    """batch: {'img1', 'img2': (N, H, W, C), 'label': (N,)} ->
    ({'score1', 'score2', 'loss', 'rank_accuracy'}, new_state).

    Both images run through the encoder in one batched pass (weight sharing
    by construction, one set of BN statistics).  ``generator`` is unused
    (the model has no dropout); it keeps the trainer's call signature."""
    img1 = torch.as_tensor(batch["img1"])
    n = img1.shape[0]
    stacked = torch.cat([img1, torch.as_tensor(batch["img2"]).to(img1)], 0)
    scores, new_state = encode(params, state, stacked, cfg, train=train)
    s1, s2 = scores[:n], scores[n:]
    label = torch.as_tensor(batch["label"]).to(s1)
    out = {
        "score1": s1,
        "score2": s2,
        "loss": pair_rank_loss(s1, s2, label, margin=cfg.margin),
        "rank_accuracy": rank_accuracy_torch(s1, s2, label),
    }
    return out, new_state
