"""Operations, bytes and the card's peaks: the arithmetic behind every
roofline share and every ``mfu`` the benchmark reports.

The peaks are those of NVIDIA's data sheet for the H100 SXM (dense rates,
no sparsity), which assume the card's full power limit of 700 W; a run
records the card's own ``power.limit`` beside them (``card_power_limit``).

The pair maps' products must be float32-accurate.  The card's fastest way
to that is 3xTF32 on the tensor cores (three TF32 products per float32
one, the forward kernel's design): 495 / 3 = 165 TFLOP/s, above the
67 TFLOP/s of float32 FMAs.  So the pair maps' bound, and the training
step's ``mfu``, count every float32 product at that rate.

A kernel's bound is the larger of its operations over the peak of its
operand type and its bytes over the HBM rate, each input read once and
each output written once, whatever the kernel reads again.
"""

from __future__ import annotations

import math
import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"3xtf32": 495e12 / 3, "bf16": 989e12, "int8": 1979e12}
# the peak each MaxSim pool type's products run at
MAXSIM_PEAK = {"bf16": "bf16", "int8": "int8", "int4": "int8"}
PAIR_MAPS_PEAK = "3xtf32"


def bound_s(ops: float, nbytes: float, peak: str) -> tuple[float, str]:
    """The least time the card could take, in seconds, and which of
    "operations" or "bytes" sets it."""
    by_ops = ops / PEAK_OPS_PER_S[peak]
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ------------------------------------------------------------------ MaxSim
def maxsim_ops(nq: int, c: int, d: int, w1: int, w2: int, m: int) -> float:
    """2 Nq R C W2 D multiply-adds as operations, R = M W1 projected query
    rows, at the unpadded widths."""
    return 2.0 * nq * m * w1 * c * w2 * d


def maxsim_bytes(nq: int, c: int, d: int, w1: int, w2: int, m: int,
                 dtype: str) -> float:
    """The packed operands as the port's layouts hold them, read once, and
    the (Nq, C) float32 scores written once.  bf16: Dp = round_up(D + 1,
    16) lanes of 2 bytes; int8: Dp = round_up(D, 32) bytes and a (C, 2)
    bf16 aux, the query rows' float32 scales; int4: half the int8 pool."""
    r, w2p = m * w1, round_up(w2, 8)
    if dtype == "bf16":
        dp = round_up(d + 1, 16)
        operands = 2 * (nq * r * dp + c * w2p * dp)
    else:
        dp = round_up(d, 32)
        pool = c * w2p * dp // (2 if dtype == "int4" else 1)
        operands = nq * r * dp + 4 * nq * r + pool + 4 * c
    return float(operands + 4 * nq * c)


def maxsim_bound_s(nq: int, c: int, d: int, w1: int, w2: int, m: int,
                   dtype: str) -> tuple[float, str]:
    return bound_s(maxsim_ops(nq, c, d, w1, w2, m),
                   maxsim_bytes(nq, c, d, w1, w2, m, dtype),
                   MAXSIM_PEAK[dtype])


def projection_ops(nq: int, d: int, w1: int, m: int) -> float:
    """The queries' projection through the M metric matrices."""
    return 2.0 * nq * w1 * m * d * d


def query_call_ops(nq: int, c: int, d: int, w1: int, w2: int,
                   m: int) -> float:
    """What one ``QueryEngine.query`` call of Nq queries over C candidates
    needs: the scoring and the projection."""
    return maxsim_ops(nq, c, d, w1, w2, m) + projection_ops(nq, d, w1, m)


# --------------------------------------------------------------- pair maps
PAIR_MAPS = ("pair_maps_fwd", "pair_maps_bwd_qa", "pair_maps_bwd_w")


def pair_maps_ops(name: str, n: int, d: int, w1: int, w2: int,
                  m: int) -> float:
    """2 N M W1 D (D + W2): q W_m, then its product with the answer tokens;
    dQ and dA together twice that, dW once."""
    ops = 2.0 * n * m * w1 * d * (d + w2)
    return 2 * ops if name == "pair_maps_bwd_qa" else ops


def pair_maps_bytes(name: str, n: int, d: int, w1: int, w2: int,
                    m: int) -> float:
    """float32 q, a, W and the map (or its gradient) read or written once;
    dQ/dA also writes dQ and dA."""
    q, a, w, g = n * w1 * d, n * w2 * d, m * d * d, n * w1 * w2 * m
    floats = {"pair_maps_fwd": q + a + w + g,
              "pair_maps_bwd_w": q + a + g + w,
              "pair_maps_bwd_qa": q + a + w + g + q + a}[name]
    return 4.0 * floats


def pair_maps_bound_s(name: str, n: int, d: int, w1: int, w2: int,
                      m: int) -> tuple[float, str]:
    return bound_s(pair_maps_ops(name, n, d, w1, w2, m),
                   pair_maps_bytes(name, n, d, w1, w2, m), PAIR_MAPS_PEAK)


# ---------------------------------------------------------- the V4 family
def conv_stack(cfg: dict) -> list[tuple[int, int, int, int, int, int]]:
    """(in H, in W, in C, out H, out W, out C) of each conv, VALID, with
    the ceil-mode pooling after it, from the configuration's blocks."""
    h, w, c = cfg["question_len"], cfg["answer_len"], cfg["sim_measures"]
    out = []
    for kh, kw, oc, _pool, pk, ps in cfg["blocks"]:
        ch, cw = h - kh + 1, w - kw + 1
        out.append((h, w, c, ch, cw, oc))
        h = int(math.ceil((ch - pk) / ps)) + 1
        w = int(math.ceil((cw - pk) / ps)) + 1
        c = oc
    return out


def features(cfg: dict) -> int:
    """Width of the flatten after the last block, overlap features added."""
    h, w, c = cfg["question_len"], cfg["answer_len"], cfg["sim_measures"]
    for kh, kw, oc, _pool, pk, ps in cfg["blocks"]:
        h = int(math.ceil((h - kh + 1 - pk) / ps)) + 1
        w = int(math.ceil((w - kw + 1 - pk) / ps)) + 1
        c = oc
    return h * w * c + cfg["overlap_features"]


def forward_flops(cfg: dict) -> float:
    """Multiply-adds of one sample's forward, as operations: the pair maps,
    each conv, fc1 and fc2 (elementwise work, BN and pooling left out)."""
    d, w1, w2, m = (cfg["embed_dim"], cfg["question_len"],
                    cfg["answer_len"], cfg["sim_measures"])
    flops = pair_maps_ops("pair_maps_fwd", 1, d, w1, w2, m)
    for (_h, _w, c, oh, ow, oc), (kh, kw, *_rest) in zip(conv_stack(cfg),
                                                         cfg["blocks"]):
        flops += 2.0 * oh * ow * oc * kh * kw * c
    flops += 2.0 * features(cfg) * cfg["fc1_dim"]
    flops += 2.0 * cfg["fc1_dim"] * cfg["num_classes"]
    return flops


def train_flops(cfg: dict) -> float:
    """One sample's forward and backward: the backward of each product
    takes two (the gradient of its input and of its weight), the first
    conv's input gradient included, since the metric learns through it."""
    return 3.0 * forward_flops(cfg)


# ---------------------------------------------------------------- the card
def card_power_limit() -> str:
    """``nvidia-smi``'s power limit of the first card, or "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"
