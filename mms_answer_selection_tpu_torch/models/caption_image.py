"""Caption-to-image ranking, the multimodal text x image metric of
configs[4] (counterpart of ``models/caption_image.py``).

A CNN encodes an image into patch embeddings in the same D-dim space as
the word embeddings, and the learned bilinear metric scores a caption
against an image as

    score(caption, image) = sum_m sum_i max_p t_i^T W_m v_p,

the SimCross-mode-2 + MaxSim structure of the QA path with image patches
in the candidate-token role.  So the same kernels serve it: training goes
through ``sim_cross_bilinear`` (the pair-map forward, dQ/dA and dW kernels
on CUDA tensors), and an image pool is served by ``QueryEngine.
build_index_from_tokens`` on ``encode_image``'s patches through MaxSim.

Training: triplet ranking with PairRankLoss over (caption, positive image,
negative image).  Both images run the encoder in one pass, concatenated on
the batch axis (one set of BN statistics, as in the reference package),
and the caption is scored against each in its own call.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..metrics.ir_metrics import rank_accuracy_torch
from ..ops import embed_init, embed_lookup, pair_rank_loss
from ..ops.pooling import _out_size
from ..ops.similarity import sim_cross_bilinear
from ..utils import fillers
from .mms_qa import ConvBlock
from .pair_image import conv_blocks_apply, conv_blocks_init


@dataclasses.dataclass(frozen=True)
class CaptionImageConfig:
    vocab_size: int = 100
    embed_dim: int = 50            # shared text / image token space
    caption_len: int = 12
    height: int = 16
    width: int = 16
    channels: int = 3
    blocks: Sequence[ConvBlock] = (
        ConvBlock(3, 3, 16, "max", 2, 2),
        ConvBlock(3, 3, 32, "max", 1, 1),
    )
    sim_measures: int = 2
    margin: float = 1.0

    def patch_grid(self) -> tuple[int, int]:
        h, w = self.height, self.width
        for b in self.blocks:
            h, w = h - b.kh + 1, w - b.kw + 1
            h = _out_size(h, b.pool_k, b.pool_stride)
            w = _out_size(w, b.pool_k, b.pool_stride)
        return h, w


def caption_image_init(cfg: CaptionImageConfig, *,
                       generator: torch.Generator, pretrained=None,
                       device=None):
    """float32 (params, state), drawn from ``generator`` in the order
    embed, conv blocks, proj, sim.  The metric W is xavier: unlike the QA
    recipe no conv stack follows the map to bootstrap a zero W."""
    params: dict = {"embed": embed_init(generator, cfg.vocab_size,
                                        cfg.embed_dim, pretrained=pretrained,
                                        device=device)}
    convs, state, in_ch = conv_blocks_init(generator, cfg.blocks,
                                           cfg.channels, device=device)
    params.update(convs)
    # project patch channels into the shared D-dim token space
    params["proj"] = {
        "w": fillers.xavier(generator, (in_ch, cfg.embed_dim), fan_in=in_ch,
                            device=device),
        "b": torch.zeros((cfg.embed_dim,), device=device),
    }
    m, d = cfg.sim_measures, cfg.embed_dim
    params["sim"] = {"w": fillers.xavier(generator, (m, d, d), fan_in=d * d,
                                         device=device)}
    return params, state


def encode_image(params, state, images, cfg: CaptionImageConfig, *,
                 train: bool):
    """(N, H, W, C) -> ((N, P, D) patch token embeddings, new_state)."""
    x, new_state = conv_blocks_apply(params, state, images, cfg.blocks,
                                     train=train)
    patches = x.reshape(x.shape[0], -1, x.shape[-1])      # (N, P, C')
    tokens = torch.tanh(patches @ params["proj"]["w"] + params["proj"]["b"])
    return tokens, new_state


def caption_image_score(params, caption_tokens, image_tokens,
                        cfg: CaptionImageConfig):
    """MaxSim under the learned metric: (N, W1, D) x (N, P, D) -> (N,).
    ``torch.amax`` splits the gradient among tied patches, as ``jnp.max``
    does."""
    maps = sim_cross_bilinear(caption_tokens, image_tokens,
                              params["sim"]["w"])         # (N, W1, P, M)
    return torch.sum(torch.amax(maps, dim=2), dim=(1, 2))


def caption_image_apply(params, state, batch, cfg: CaptionImageConfig, *,
                        train: bool, generator: torch.Generator | None = None):
    """batch: {'caption': int (N, W1), 'image_pos', 'image_neg':
    (N, H, W, C)} -> ({'score_pos', 'score_neg', 'loss', 'rank_accuracy'},
    new_state).  ``generator`` is unused (no dropout); it keeps the
    trainer's call signature."""
    cap = embed_lookup(params["embed"], torch.as_tensor(batch["caption"]))
    n = cap.shape[0]
    stacked = torch.cat([torch.as_tensor(batch["image_pos"]).to(cap),
                         torch.as_tensor(batch["image_neg"]).to(cap)], 0)
    tokens, new_state = encode_image(params, state, stacked, cfg,
                                     train=train)
    pos, neg = tokens[:n], tokens[n:]
    s_pos = caption_image_score(params, cap, pos, cfg)
    s_neg = caption_image_score(params, cap, neg, cfg)
    ones = torch.ones_like(s_pos)          # the positive should outrank
    out = {
        "score_pos": s_pos,
        "score_neg": s_neg,
        "loss": pair_rank_loss(s_pos, s_neg, ones, margin=cfg.margin),
        "rank_accuracy": rank_accuracy_torch(s_pos, s_neg, ones),
    }
    return out, new_state
