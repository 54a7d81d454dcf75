"""The MMS answer-selection model family (counterpart of
``models/mms_qa.py``).

Every variant is: a shared embedding table applied to question and answer,
a SimCross word-word similarity map, optional dropout on the map, a stack
of [conv -> BN -> pool -> tanh] blocks, flatten ++ overlap features, a
tanh+dropout MLP head to 2 logits, and softmax cross-entropy.

Parameters and BN state are nested dicts of tensors in the JAX package's
layouts (HWIO conv weights, (F, out) dense weights), so ``convert.py`` moves
weights between the two packages unchanged.  Activations stay NHWC from the
sim map to the flatten, so fc1 sees the reference's (h, w, c) flatten order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..ops import (
    avg_pool2d,
    bn_apply,
    bn_init,
    conv2d,
    conv_init,
    dropout,
    embed_init,
    embed_lookup,
    max_pool2d,
    sim_cross_bilinear,
    sim_cross_cosine,
    sim_cross_inv_euclidean,
    softmax_cross_entropy,
)
from ..utils import fillers
from ..utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    """conv(kh x kw, out_ch) -> BN -> pool(pk x pk, stride ps) -> tanh."""
    kh: int
    kw: int
    out_channels: int
    pool: str  # "max" | "ave"
    pool_k: int
    pool_stride: int


@dataclasses.dataclass(frozen=True)
class MMSQAConfig:
    vocab_size: int = 100
    embed_dim: int = 50
    question_len: int = 40
    answer_len: int = 40
    sim_mode: int = 2            # 0 cosine / 1 inv-euclidean / 2 bilinear
    sim_measures: int = 4
    sim_bias: bool = True
    sim_dropout: float = 0.1
    blocks: Sequence[ConvBlock] = (
        ConvBlock(5, 5, 32, "ave", 4, 4),
        ConvBlock(5, 5, 64, "ave", 5, 1),
    )
    overlap_features: int = 2
    fc1_dim: int = 32
    fc1_dropout: float = 0.5
    num_classes: int = 2
    embed_init_range: float = 0.08
    sim_weight_init: str = "zeros"   # the reference's default constant filler
    bn_shift_init: float = 1e-3

    def sim_channels(self) -> int:
        return self.sim_measures if self.sim_mode == 2 else 1


def _v(blocks, **kw):
    return dataclasses.replace(MMSQAConfig(), blocks=tuple(blocks), **kw)


V3 = _v([ConvBlock(5, 5, 64, "max", 4, 4), ConvBlock(5, 5, 64, "max", 5, 1)],
        sim_mode=0, sim_measures=1, sim_bias=False, sim_dropout=0.0,
        fc1_dim=64)
V4 = MMSQAConfig()
V4_2 = _v([ConvBlock(5, 5, 32, "ave", 2, 2), ConvBlock(5, 5, 32, "ave", 2, 2),
           ConvBlock(5, 5, 32, "ave", 3, 3)],
          sim_measures=2, sim_bias=False, sim_dropout=0.0, fc1_dim=64)
V5 = _v([ConvBlock(3, 3, 32, "max", 2, 2), ConvBlock(4, 4, 32, "max", 2, 2),
         ConvBlock(3, 3, 32, "max", 6, 6)],
        sim_measures=2, sim_bias=True, sim_dropout=0.2, fc1_dim=32)
V4_WIDE = _v([ConvBlock(5, 5, 64, "ave", 4, 4),
              ConvBlock(5, 5, 128, "ave", 5, 1)],
             embed_dim=300, fc1_dim=64)


def _spatial_after_blocks(cfg: MMSQAConfig) -> tuple[int, int, int]:
    h, w = cfg.question_len, cfg.answer_len
    c = cfg.sim_channels()
    for b in cfg.blocks:
        h, w = h - b.kh + 1, w - b.kw + 1
        h = int(math.ceil((h - b.pool_k) / b.pool_stride)) + 1
        w = int(math.ceil((w - b.pool_k) / b.pool_stride)) + 1
        c = b.out_channels
    return h, w, c


def mms_qa_init(cfg: MMSQAConfig, *, generator: torch.Generator,
                pretrained=None, device=None):
    """Build float32 (params, state), drawing from ``generator`` in the
    order embed, sim (xavier only), conv blocks, fc1, fc2.  ``pretrained``
    (n, D) vectors overwrite embedding rows [0, n) (``embed_init``)."""
    params: dict = {}
    state: dict = {}
    params["embed"] = embed_init(
        generator, cfg.vocab_size, cfg.embed_dim, pretrained=pretrained,
        minval=-cfg.embed_init_range, maxval=cfg.embed_init_range,
        device=device)
    if cfg.sim_mode == 2:
        m, d = cfg.sim_measures, cfg.embed_dim
        if cfg.sim_weight_init == "zeros":
            w = torch.zeros((m, d, d), device=device)
        elif cfg.sim_weight_init == "xavier":
            w = fillers.xavier(generator, (m, d, d), fan_in=d * d,
                               device=device)
        else:
            raise ValueError(cfg.sim_weight_init)
        params["sim"] = {"w": w}
        if cfg.sim_bias:
            params["sim"]["b"] = torch.zeros(
                (m, cfg.question_len, cfg.answer_len), device=device)
    in_ch = cfg.sim_channels()
    for i, b in enumerate(cfg.blocks):
        params[f"conv{i}"] = conv_init(generator, in_ch, b.out_channels,
                                       b.kh, b.kw, device=device)
        params[f"bn{i}"], state[f"bn{i}"] = bn_init(
            b.out_channels, shift_value=cfg.bn_shift_init, device=device)
        in_ch = b.out_channels
    h, w, c = _spatial_after_blocks(cfg)
    feat_dim = h * w * c + cfg.overlap_features
    params["fc1"] = {
        "w": fillers.xavier(generator, (feat_dim, cfg.fc1_dim),
                            fan_in=feat_dim, device=device),
        "b": torch.zeros((cfg.fc1_dim,), device=device),
    }
    params["fc2"] = {
        "w": fillers.xavier(generator, (cfg.fc1_dim, cfg.num_classes),
                            fan_in=cfg.fc1_dim, device=device),
        "b": torch.zeros((cfg.num_classes,), device=device),
    }
    return params, state


def sim_map(params, q_emb, a_emb, cfg: MMSQAConfig):
    """The SimCross stage: (N,W1,D),(N,W2,D) -> (N,W1,W2,M|1)."""
    if cfg.sim_mode == 0:
        return sim_cross_cosine(q_emb, a_emb)
    if cfg.sim_mode == 1:
        return sim_cross_inv_euclidean(q_emb, a_emb)
    sim = params["sim"]
    return sim_cross_bilinear(q_emb, a_emb, sim["w"], sim.get("b"))


def mms_qa_apply(params, state, batch, cfg: MMSQAConfig, *, train: bool,
                 generator: torch.Generator | None = None, q_emb=None,
                 a_emb=None):
    """Forward pass.

    batch: {'question': int (N, W1), 'answer': int (N, W2),
            'overlap_feat': (N, F), optional 'label': int (N,)}
    Returns (out, new_state) with out = {'logits', 'prob'[, 'loss']}.
    ``generator`` drives dropout and is required when ``train``.

    q_emb / a_emb: optional (N, W, D) embedding activations that replace
    the table lookups, so a caller can differentiate the loss with respect
    to them (``utils/saliency.py``).
    """
    if train and generator is None:
        raise ValueError("training forward needs a dropout generator")
    if q_emb is None:
        q_emb = embed_lookup(params["embed"], batch["question"])
    if a_emb is None:
        a_emb = embed_lookup(params["embed"], batch["answer"])
    x = sim_map(params, q_emb, a_emb, cfg)
    if train and cfg.sim_dropout > 0:
        x = dropout(generator, x, cfg.sim_dropout)

    new_state = dict(state)
    for i, b in enumerate(cfg.blocks):
        x = conv2d(params[f"conv{i}"], x)
        x, new_state[f"bn{i}"] = bn_apply(params[f"bn{i}"], state[f"bn{i}"],
                                          x, train=train)
        pool = max_pool2d if b.pool == "max" else avg_pool2d
        x = torch.tanh(pool(x, b.pool_k, b.pool_k, stride_h=b.pool_stride,
                            stride_w=b.pool_stride))

    flat = x.reshape(x.shape[0], -1)                  # NHWC (h, w, c) order
    feat = torch.cat([flat, batch["overlap_feat"].to(flat)], dim=1)
    h = torch.tanh(feat @ params["fc1"]["w"] + params["fc1"]["b"])
    if train and cfg.fc1_dropout > 0:
        h = dropout(generator, h, cfg.fc1_dropout)
    logits = (h @ params["fc2"]["w"] + params["fc2"]["b"]).to(torch.float32)

    out = {"logits": logits, "prob": torch.softmax(logits, dim=-1)}
    if "label" in batch:
        out["loss"] = softmax_cross_entropy(logits, batch["label"])
    return out, new_state


def param_spec(params, cfg: MMSQAConfig):
    """Per-parameter (lr_mult, decay_mult) tree matching the recipe's
    ParamSpecs: embed w (1, 0) and b (2, 0); sim W and bias (1, 1); conv w
    (1, 1) and b (2, 0); BN scale and shift (1, 0) (running statistics live
    in the state, untouched by the solver); fc w (1, 0) and b (2, 0);
    anything else (1, 1)."""
    spec = {}
    for name, sub in params.items():
        if name == "embed":
            spec[name] = {"w": (1.0, 0.0)}
            if "b" in sub:
                spec[name]["b"] = (2.0, 0.0)
        elif name == "sim":
            spec[name] = {k: (1.0, 1.0) for k in sub}
        elif name.startswith("conv"):
            spec[name] = {"w": (1.0, 1.0), "b": (2.0, 0.0)}
        elif name.startswith("bn"):
            spec[name] = {"scale": (1.0, 0.0), "shift": (1.0, 0.0)}
        elif name.startswith("fc"):
            spec[name] = {"w": (1.0, 0.0), "b": (2.0, 0.0)}
        else:
            spec[name] = tree_map(lambda _: (1.0, 1.0), sub)
    return spec
