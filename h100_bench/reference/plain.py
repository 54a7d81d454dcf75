"""The plain reference the benchmark holds the port against: the V4 family's
forward, loss, gradients (autograd) and the recipe's AdaDelta step, and
learned-metric MaxSim scoring with the pool's quantization, in plain
float32 PyTorch with TF32 off.

It imports nothing of the program.  What the program derives from the
benchmark's inputs, it works out again here from the same inputs: the
initial weights from the trainer's seed (the same fillers drawn in the
same order from a CPU generator), each pass's shuffle, each step's
dropout masks (a generator on the device seeded per step), the packed
pool's codes and scales and the projected queries.

The model, as the recipe defines it: a shared embedding table with a
bias; the bilinear sim map out[n, i, j, m] = q_i^T W_m a_j + b[m, i, j];
dropout on the map; per block a VALID conv, BN-v0 (biased variance,
eps 1e-9 added to it, running statistics by an EMA of 0.9), Caffe's
ceil-mode average pooling over the elements each window covers, tanh;
the (h, w, c) flatten with the overlap features; tanh fc1, dropout, fc2;
softmax cross-entropy, each sample's loss capped at -log(FLT_MIN).
AdaDelta as the recipe's solver runs it: weight decay folded into the
gradient by each leaf's decay multiplier, h = (1-m) g^2 + m h,
u = g sqrt((h2 + eps) / (h + eps)), h2 = (1-m) u^2 + m h2,
p -= lr * lr_mult * u.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

CE_CAP = float(-np.log(np.float32(np.finfo(np.float32).tiny)))
BN_EPS, BN_MEMORY = 1e-9, 0.9
DROPOUT_TAG, SHUFFLE_TAG = 1, 2


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 products at full precision (``tf32`` False), or in TF32 on
    the tensor cores, for matmuls and cuDNN alike."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def derive_seed(*ints: int) -> int:
    """A 63-bit seed that is a fixed function of ``ints``."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


# ------------------------------------------------------------------ weights
def _uniform(gen, shape, lo: float, hi: float, device):
    x = torch.rand(tuple(shape), generator=gen)
    return (x * (hi - lo) + lo).to(device=device, dtype=torch.float32)


def _xavier(gen, shape, fan_in: int, device):
    s = (3.0 / float(fan_in)) ** 0.5
    return _uniform(gen, shape, -s, s, device)


def pooled(size: int, k: int, s: int) -> int:
    return int(math.ceil((size - k) / s)) + 1


def feature_dim(cfg: dict) -> int:
    h, w, c = cfg["question_len"], cfg["answer_len"], cfg["sim_measures"]
    for kh, kw, oc, _pool, pk, ps in cfg["blocks"]:
        h, w, c = pooled(h - kh + 1, pk, ps), pooled(w - kw + 1, pk, ps), oc
    return h * w * c + cfg["overlap_features"]


def init(cfg: dict, seed: int, device):
    """(params, state) drawn from a CPU generator seeded with ``seed``, in
    the order embed, sim (xavier only), conv blocks, fc1, fc2."""
    gen = torch.Generator().manual_seed(int(seed))
    z = lambda *s: torch.zeros(s, device=device)           # noqa: E731
    d, m = cfg["embed_dim"], cfg["sim_measures"]
    r = cfg["embed_init_range"]
    params = {"embed": {"w": _uniform(gen, (cfg["vocab_size"], d), -r, r,
                                      device), "b": z(d)}}
    if cfg["sim_weight_init"] == "zeros":
        w = z(m, d, d)
    else:
        w = _xavier(gen, (m, d, d), d * d, device)
    params["sim"] = {"w": w}
    if cfg["sim_bias"]:
        params["sim"]["b"] = z(m, cfg["question_len"], cfg["answer_len"])
    state = {}
    cin = m
    for i, (kh, kw, oc, *_rest) in enumerate(cfg["blocks"]):
        params[f"conv{i}"] = {"w": _xavier(gen, (kh, kw, cin, oc),
                                           cin * kh * kw, device), "b": z(oc)}
        params[f"bn{i}"] = {"scale": torch.ones(oc, device=device),
                            "shift": torch.full((oc,), cfg["bn_shift_init"],
                                                device=device)}
        state[f"bn{i}"] = {"mean": z(oc), "var": z(oc)}
        cin = oc
    feat, f1 = feature_dim(cfg), cfg["fc1_dim"]
    params["fc1"] = {"w": _xavier(gen, (feat, f1), feat, device), "b": z(f1)}
    params["fc2"] = {"w": _xavier(gen, (f1, cfg["num_classes"]), f1, device),
                     "b": z(cfg["num_classes"])}
    return params, state


def multipliers(params) -> dict:
    """(lr_mult, decay_mult) of each leaf, the recipe's ParamSpecs: embed w
    (1, 0), b (2, 0); sim W and bias (1, 1); conv w (1, 1), b (2, 0); BN
    scale and shift (1, 0); fc w (1, 0), b (2, 0)."""
    out = {}
    for name, sub in params.items():
        for leaf in sub:
            if name == "sim":
                spec = (1.0, 1.0)
            elif name.startswith("conv"):
                spec = (1.0, 1.0) if leaf == "w" else (2.0, 0.0)
            elif name.startswith("bn"):
                spec = (1.0, 0.0)
            else:                       # embed, fc
                spec = (1.0, 0.0) if leaf == "w" else (2.0, 0.0)
            out[f"{name}.{leaf}"] = spec
    return out


def leaves(tree) -> dict:
    """{'group.leaf': tensor} of a two-level tree."""
    return {f"{g}.{k}": v for g, sub in tree.items() for k, v in sub.items()}


# ------------------------------------------------------------------ forward
def _avg_pool(x, k: int, s: int):
    """NCHW ceil-mode average over the elements each window covers."""
    h, w = x.shape[2], x.shape[3]
    ph, pw = pooled(h, k, s), pooled(w, k, s)
    x = F.pad(x, (0, (pw - 1) * s + k - w, 0, (ph - 1) * s + k - h))
    sums = F.avg_pool2d(x, k, s, divisor_override=1)
    rows = torch.arange(ph, device=x.device) * s
    cols = torch.arange(pw, device=x.device) * s
    ch = (torch.clamp(rows + k, max=h) - rows).float()
    cw = (torch.clamp(cols + k, max=w) - cols).float()
    return sums / (ch[:, None] * cw[None, :])


def _dropout(gen, x, ratio: float):
    keep = 1.0 - ratio
    u = torch.rand(x.shape, generator=gen, device=gen.device)
    return torch.where(u.to(x.device) < keep, x / keep, torch.zeros_like(x))


def embed(params, ids):
    e = params["embed"]
    ids = ids.to(torch.int64).clamp(0, e["w"].shape[0] - 1)
    return e["w"][ids] + e["b"]


def forward(cfg: dict, params, state, batch, *, gen=None):
    """(loss, logits, new BN state); ``gen`` draws the dropout masks of a
    training forward (None: an eval forward)."""
    q, a = embed(params, batch["question"]), embed(params, batch["answer"])
    x = torch.einsum("nid,mde,nje->nijm", q, params["sim"]["w"], a)
    if "b" in params["sim"]:
        x = x + params["sim"]["b"].permute(1, 2, 0)
    if gen is not None and cfg["sim_dropout"] > 0:
        x = _dropout(gen, x, cfg["sim_dropout"])
    x = x.permute(0, 3, 1, 2)                              # NCHW
    new_state = {}
    for i, (_kh, _kw, _oc, pool, pk, ps) in enumerate(cfg["blocks"]):
        c = params[f"conv{i}"]
        x = F.conv2d(x, c["w"].permute(3, 2, 0, 1)) + c["b"][:, None, None]
        bn, st = params[f"bn{i}"], state[f"bn{i}"]
        if gen is not None:
            mu = x.mean(dim=(0, 2, 3))
            var = (x * x).mean(dim=(0, 2, 3)) - mu * mu
            new_state[f"bn{i}"] = {
                "mean": (1 - BN_MEMORY) * mu.detach() + BN_MEMORY * st["mean"],
                "var": (1 - BN_MEMORY) * var.detach() + BN_MEMORY * st["var"]}
        else:
            mu, var = st["mean"], st["var"]
            new_state[f"bn{i}"] = st
        inv = torch.rsqrt(var + BN_EPS) * bn["scale"]
        x = (x - mu[:, None, None]) * inv[:, None, None] \
            + bn["shift"][:, None, None]
        if pool != "ave":
            raise ValueError(f"the reference pools by 'ave' only, not {pool}")
        x = torch.tanh(_avg_pool(x, pk, ps))
    flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    feat = torch.cat([flat, batch["overlap_feat"].float()], 1)
    h = torch.tanh(feat @ params["fc1"]["w"] + params["fc1"]["b"])
    if gen is not None and cfg["fc1_dropout"] > 0:
        h = _dropout(gen, h, cfg["fc1_dropout"])
    logits = h @ params["fc2"]["w"] + params["fc2"]["b"]
    per = -torch.log_softmax(logits, -1).gather(
        1, batch["label"].long()[:, None])[:, 0]
    per = per - (per - torch.clamp(per, max=CE_CAP)).detach()
    return per.mean(), logits, new_state


# ------------------------------------------------------------------ training
def epoch_order(seed: int, n: int) -> torch.Tensor:
    """The first pass's shuffle of ``n`` training rows."""
    gen = torch.Generator().manual_seed(derive_seed(seed, SHUFFLE_TAG, 0))
    return torch.randperm(n, generator=gen)


def adadelta(params, grads, h, h2, solver: dict, mults: dict):
    """One in-place AdaDelta update of the leaves; returns the gradients as
    the rule took them (weight decay folded in)."""
    m, eps = solver["momentum"], solver["delta"]
    lr, wd = solver["base_lr"], solver["weight_decay"]
    taken = {}
    for k, p in params.items():
        lr_mult, decay_mult = mults[k]
        g = grads[k]
        if decay_mult:
            g = g + (wd * decay_mult) * p
        h[k] = (1 - m) * g * g + m * h[k]
        u = g * torch.sqrt((h2[k] + eps) / (h[k] + eps))
        h2[k] = (1 - m) * u * u + m * h2[k]
        p.sub_(lr * lr_mult * u)
        taken[k] = g
    return taken


def train(cfg: dict, solver: dict, seed: int, data: dict, batch: int,
          steps: int, device, *, tf32: bool = False, keep: int = 1,
          rows=None) -> dict:
    """``steps`` recipe steps from the seed's initial weights on the first
    pass's batches of ``data`` (host arrays).  Returns {'losses' (steps,),
    'grads': the first step's gradients as AdaDelta took them, 'init' and
    'params': leaf dicts before the first step and after the last, 'h':
    AdaDelta's average of g^2 after the last}.

    ``tf32``: products in TF32 (the control).  ``keep`` / ``rows``: planted
    faults, each step's batch cut to its first ``batch // keep`` rows, the
    mean loss over those; or ``rows`` the number of rows each step reads."""
    params, state = init(cfg, seed, device)
    flat = leaves(params)
    init_leaves = {k: v.clone() for k, v in flat.items()}
    mults = multipliers(params)
    h = {k: torch.zeros_like(v) for k, v in flat.items()}
    h2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    order = epoch_order(seed, len(data["label"]))
    cols = {k: torch.as_tensor(v) for k, v in data.items() if k != "group"}
    losses, first = [], None
    with precision(tf32):
        for step in range(steps):
            idx = order[step * batch:(step + 1) * batch]
            b = {k: v[idx].to(device) for k, v in cols.items()}
            gen = torch.Generator(device=device).manual_seed(
                derive_seed(seed, DROPOUT_TAG, step))
            if keep > 1 or rows is not None:
                n = rows if rows is not None else batch // keep
                b = {k: v[:n] for k, v in b.items()}
            for t in flat.values():
                t.requires_grad_(True)
            loss, _, state = forward(cfg, params, state, b, gen=gen)
            grads = torch.autograd.grad(loss, list(flat.values()))
            for t in flat.values():
                t.requires_grad_(False)
            taken = adadelta(flat, dict(zip(flat, grads)), h, h2, solver,
                             mults)
            if first is None:
                first = {k: g.detach().clone() for k, g in taken.items()}
            losses.append(loss.detach())
    return {"losses": torch.stack(losses).cpu(), "grads": first,
            "init": init_leaves, "h": h,
            "params": {k: v.detach().clone() for k, v in flat.items()}}


# ------------------------------------------------------------------- MaxSim
def quantize(x: torch.Tensor, dims, bound: float):
    """Symmetric codes (as float32) and scales of ``x`` over ``dims``:
    scale = max(absmax, 1e-12) / bound, codes = clip(round_half_even(x /
    scale), -bound, bound)."""
    scale = torch.clamp(x.abs().amax(dim=dims, keepdim=True), min=1e-12) \
        / bound
    return torch.clamp(torch.round(x / scale), -bound, bound), scale


def project(q_tokens: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(S, W1, D) x (M, D, D) -> (S, M*W1, D) float32, rows ordered (m, i)."""
    s, w1, d = q_tokens.shape
    return torch.einsum("nid,mde->nmie", q_tokens, w).reshape(s, -1, d)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def maxsim_scores(q_tokens: torch.Tensor, embed_of, pool: int,
                  w: torch.Tensor, dtype: str, block: int) -> torch.Tensor:
    """(S, pool) MaxSim scores sum_r max_j <qw_r, c_j> of S queries'
    tokens against every candidate, whose float32 tokens ``embed_of(a, b)``
    gives block by block, with the pool's precision as the port's packing
    defines it:

    * bf16: the projected query rows and the candidate tokens rounded to
      bf16, their products summed in float32;
    * int8 / int4: each candidate's tokens coded on one symmetric scale
      (+-127 / +-7) over its (W2, D) values, each projected query row on
      its own; the exact integer dot products, times the query row's scale
      and the candidate's scale, each rounded to bf16, summed over rows.
    """
    qw = project(q_tokens, w)
    s, r, d = qw.shape
    out = torch.empty((s, pool), device=qw.device)
    if dtype == "bf16":
        a = _bf16(qw).reshape(s * r, d)
    else:
        bound = 127.0 if dtype == "int8" else 7.0
        codes, sq = quantize(qw, (-1,), bound)
        a = codes.reshape(s * r, d)
        sq = _bf16(sq)                                      # (S, R, 1)
    for c0 in range(0, pool, block):
        tok = embed_of(c0, min(pool, c0 + block)).to(torch.float32)
        n, w2 = tok.shape[0], tok.shape[1]
        if dtype == "bf16":
            sims = a @ _bf16(tok).reshape(n * w2, d).T
            out[:, c0:c0 + n] = sims.view(s, r, n, w2).amax(-1).sum(1)
        else:
            ccodes, sc = quantize(tok, (1, 2), bound)
            sims = a @ ccodes.reshape(n * w2, d).T
            mx = sims.view(s, r, n, w2).amax(-1)
            out[:, c0:c0 + n] = ((mx * sq) * _bf16(sc.reshape(1, 1, n))
                                 ).sum(1)
    return out
