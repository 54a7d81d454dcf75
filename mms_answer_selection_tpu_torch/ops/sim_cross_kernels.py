"""Kernels of the learned bilinear metric (counterpart of
``ops/sim_cross_pallas.py``): the training-path pair maps and the
retrieval-path MaxSim scorers.

Pair maps: out[n, i, j, m] = q_{n,i}^T W_m a_{n,j}, NHWC (N, W1, W2, M), as
a ``torch.autograd.Function`` whose backward is the closed form of the
reference's custom VJP (dQ, dA in one kernel, dW in another).

MaxSim: score(q, c) = sum_m sum_i max_j q_i^T W_m c_j.  The queries are
projected through the M metric matrices once (``project_queries*``),
giving R = M*W1 rows per query; each candidate is packed once
(``pack_candidate_pool*``); the scorers then compute sum_r max_j <qw_r,
c_j> for every (query, candidate) pair without materializing the (Nq*R) x
(C*W2) similarity tensor.

Packed formats (this port's own; the reference padded D to 128 lanes):

* bf16: pool (C, W2P, Dp) with Dp = round_up(D + 1, 16).  The last lane
  is the token mask: 0 for real tokens, -1e30 for padded tokens and masked
  candidates; the projected queries hold 1.0 there, so the mask rides the
  dot product.
* int8: pool (C, W2P, Dp) int8 with Dp = round_up(D, 32), one symmetric
  scale per candidate, padded token rows duplicating token 0; aux (C, 2)
  bf16 holds the candidate scale (lane 0) and an additive mask (lane 1).
  Queries carry one f32 scale per projected row.

W2P = round_up(W2, 8) in both.  Scorers take any Dp, so the reference
packers' 128-lane outputs score here too.

Each entry point is a wrapper over a hand-written CUDA kernel (``csrc/``).
On CPU tensors the wrapper runs the plain PyTorch version beside it; on
CUDA tensors it launches the kernel or raises.  ``LAUNCH_COUNTS`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30

# kernel name -> launches since the counter was last reset
LAUNCH_COUNTS = {"maxsim_bf16": 0, "maxsim_int8": 0, "pair_maps_fwd": 0,
                 "pair_maps_bwd_qa": 0, "pair_maps_bwd_w": 0}

# How far a kernel may stray from its plain version on the same operands.
# MaxSim, as a fraction of the row's largest |score|: int8, each row's term
# is the same three IEEE float32 products in both, only the order of the
# sum over rows differs; bf16, the tensor cores also accumulate each
# 16-term dot product in their own order and rounding.  Pair maps, as a
# fraction of the output's (out, dQ, dA or dW) largest |value|: float32
# FMAs in both, only the order of the sums over D, W1, W2, M and the batch
# differs (no TF32, no reduced precision).
KERNEL_VS_PLAIN_RTOL = {"maxsim_bf16": 1e-4, "maxsim_int8": 1e-5,
                        "pair_maps_fwd": 1e-5, "pair_maps_bwd_qa": 1e-5,
                        "pair_maps_bwd_w": 1e-5}

_SMEM_BYTES = 232448   # dynamic shared memory one sm_90 block may use
_PLAIN_CHUNK_BYTES = 1 << 30  # similarity slab the plain versions hold
PAIR_MAPS_MAX_W = 64   # largest W1, W2 the pair-map kernels take (MAXW)
_DW_CHUNK = 8          # samples one dW block sums before the partials' sum
_GRID_Y = 65535        # largest gridDim.y and gridDim.z of a launch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------- pair maps
def bilinear_pair_maps_plain(q, a, w):
    """Plain PyTorch version of ``pair_maps_fwd``: (N, W1, D), (N, W2, D),
    (M, D, D) -> (N, W1, W2, M).  On CUDA this needs
    ``torch.backends.cuda.matmul.allow_tf32`` off (the default)."""
    return torch.einsum("nid,mde,nje->nijm", q, w, a)


def bilinear_pair_maps_grads_plain(q, a, w, g, *, need_qa=True,
                                   need_w=True):
    """Plain PyTorch version of the two backward kernels: the closed forms
    of the reference's custom VJP for g = dL/dout (N, W1, W2, M).  Returns
    (dQ, dA, dW); a gradient not asked for is None."""
    dq = da = dw = None
    if need_qa:
        dq = torch.einsum("nijm,mde,nje->nid", g, w, a)
        da = torch.einsum("nijm,mde,nid->nje", g, w, q)
    if need_w:
        dw = torch.einsum("nid,nijm,nje->mde", q, g, a)
    return dq, da, dw


def pair_maps_fwd(q, a, w):
    """The forward map (N, W1, W2, M): the ``pair_maps_fwd`` kernel on CUDA
    tensors, ``bilinear_pair_maps_plain`` on CPU tensors."""
    n, w1, w2, d, m = _pair_maps_shapes(q, a, w)
    if _on_cpu(q, a, w):
        return bilinear_pair_maps_plain(q, a, w)
    _check_pair_maps_cuda(q, a, w)
    out = torch.empty((n, w1, w2, m), dtype=torch.float32, device=q.device)
    _launch("pair_maps_fwd", q, q.data_ptr(), a.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, w1, w2, d, m)
    return out


def pair_maps_bwd_qa(q, a, w, g):
    """(dQ, dA) for g = dL/dout: the ``pair_maps_bwd_qa`` kernel on CUDA
    tensors, the plain closed forms on CPU tensors.  On CUDA a strided
    ``g`` (the conv's input gradient can arrive as one) is copied to a
    dense one first."""
    if _on_cpu(q, a, w, g):
        return bilinear_pair_maps_grads_plain(q, a, w, g, need_w=False)[:2]
    g = g.contiguous()
    n, w1, w2, d, m = _check_pair_maps_cuda(q, a, w, g=g)
    dq, da = torch.empty_like(q), torch.empty_like(a)
    _launch("pair_maps_bwd_qa", q, q.data_ptr(), a.data_ptr(), w.data_ptr(),
            g.data_ptr(), dq.data_ptr(), da.data_ptr(), n, w1, w2, d, m)
    return dq, da


def pair_maps_bwd_w(q, a, w, g):
    """dW for g = dL/dout, summed over the batch in a fixed order (two runs
    give the same bits): the ``pair_maps_bwd_w`` kernel on CUDA tensors,
    the plain closed form on CPU tensors.  ``w`` gives only the shape.  A
    strided ``g`` is copied to a dense one first, as in
    ``pair_maps_bwd_qa``."""
    if _on_cpu(q, a, w, g):
        return bilinear_pair_maps_grads_plain(q, a, w, g, need_qa=False)[2]
    g = g.contiguous()
    n, w1, w2, d, m = _check_pair_maps_cuda(q, a, w, g=g)
    dw = torch.empty_like(w)
    chunks = -(-n // _DW_CHUNK)
    part = torch.empty((chunks,) + tuple(w.shape), dtype=torch.float32,
                       device=w.device) if chunks > 1 else dw
    _launch("pair_maps_bwd_w", q, q.data_ptr(), a.data_ptr(), g.data_ptr(),
            dw.data_ptr(), part.data_ptr(), n, w1, w2, d, m, _DW_CHUNK)
    return dw


class BilinearPairMaps(torch.autograd.Function):
    """out = q W a^T per measure, with the closed-form backward:
    ``pair_maps_fwd`` forward, ``pair_maps_bwd_qa`` (dQ and dA) and
    ``pair_maps_bwd_w`` (dW) backward, each only when a gradient it makes
    is needed."""

    @staticmethod
    def forward(ctx, q, a, w):
        ctx.save_for_backward(q, a, w)
        return pair_maps_fwd(q, a, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, a, w = ctx.saved_tensors
        need_q, need_a, need_w = ctx.needs_input_grad
        dq = da = dw = None
        if need_q or need_a:
            dq, da = pair_maps_bwd_qa(q, a, w, g)
        if need_w:
            dw = pair_maps_bwd_w(q, a, w, g)
        return dq if need_q else None, da if need_a else None, dw


def bilinear_pair_maps(q, a, w):
    """Fused SimCross mode-2 map: q (N, W1, D), a (N, W2, D), w (M, D, D)
    -> (N, W1, W2, M) float32, differentiable in all three.

    CUDA operands must be contiguous float32 with W1, W2 <= 64; any D and M
    are taken (D is tiled)."""
    return BilinearPairMaps.apply(q, a, w)


def _pair_maps_shapes(q, a, w):
    if q.ndim != 3 or a.ndim != 3 or w.ndim != 3 or q.shape[0] != a.shape[0] \
            or not q.shape[2] == a.shape[2] == w.shape[1] == w.shape[2]:
        raise ValueError(f"expected q (N, W1, D), a (N, W2, D), w (M, D, D),"
                         f" got {tuple(q.shape)}, {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    n, w1, d = q.shape
    return n, w1, a.shape[1], d, w.shape[0]


def _check_pair_maps_cuda(q, a, w, **more):
    _check_cuda_operands(align=4, q=(q, torch.float32), a=(a, torch.float32),
                         w=(w, torch.float32),
                         **{k: (v, torch.float32) for k, v in more.items()})
    n, w1, w2, d, m = _pair_maps_shapes(q, a, w)
    if 0 in (n, w1, w2, d, m) or max(w1, w2) > PAIR_MAPS_MAX_W \
            or m > _GRID_Y or d > _GRID_Y * 32 or n > _GRID_Y * _DW_CHUNK:
        raise ValueError(f"the pair-map kernels take 1 <= W1, W2 <= "
                         f"{PAIR_MAPS_MAX_W}, M <= {_GRID_Y}, D <= "
                         f"{_GRID_Y * 32}, N <= {_GRID_Y * _DW_CHUNK} and "
                         f"non-empty operands, got N={n} W1={w1} W2={w2} "
                         f"D={d} M={m}")
    if "g" in more and tuple(more["g"].shape) != (n, w1, w2, m):
        raise ValueError(f"gradient {tuple(more['g'].shape)} does not match "
                         f"the map {(n, w1, w2, m)}")
    return n, w1, w2, d, m


def _project(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (Nq, M*W1, D) float32, row order (m, i)."""
    nq, w1, d = q_tokens.shape
    qw = torch.einsum("nid,mde->nmie", q_tokens.to(torch.float32),
                      w.to(torch.float32))
    return qw.reshape(nq, w.shape[0] * w1, d)


# ---------------------------------------------------------------- bf16 path
def pack_candidate_pool(tokens):
    """(C, W2, D) candidate token embeddings -> (C, W2P, Dp) bf16 pool with
    the token mask in the last lane."""
    c, w2, d = tokens.shape
    dp = _round_up(d + 1, 16)
    pool = torch.zeros((c, _round_up(w2, 8), dp), dtype=torch.bfloat16,
                       device=tokens.device)
    pool[:, :w2, :d] = tokens.to(torch.bfloat16)
    pool[:, w2:, dp - 1] = NEG_INF
    return pool


def mask_out_candidates(pool, start: int):
    """Mark candidates [start:] as padding, in place; returns ``pool``."""
    pool[start:, :, -1] = NEG_INF
    return pool


def project_queries(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (Nq, M*W1, Dp) bf16: projected in
    float32, then cast; the last lane is 1.0 to activate the pool's mask
    lane."""
    qw = _project(q_tokens, w)
    nq, r, d = qw.shape
    out = torch.zeros((nq, r, _round_up(d + 1, 16)), dtype=torch.float32,
                      device=qw.device)
    out[:, :, :d] = qw
    out[:, :, -1] = 1.0
    return out.to(torch.bfloat16)


def bilinear_maxsim_scores_plain(qw, pool):
    """Plain PyTorch version of the bf16 kernel: (Nq, C) float32 scores.

    Products and sums in float32 (exact bf16 products), one candidate
    chunk at a time so the similarity slab stays near 1 GB.  On CUDA this
    needs ``torch.backends.cuda.matmul.allow_tf32`` off (the default)."""
    nq, r, dp = qw.shape
    c, w2p, _ = pool.shape
    a = qw.reshape(nq * r, dp).to(torch.float32)
    out = torch.empty((nq, c), dtype=torch.float32, device=qw.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (nq * r * w2p * 4))
    for c0 in range(0, c, step):
        p = pool[c0:c0 + step].reshape(-1, dp).to(torch.float32)
        s = (a @ p.T).view(nq, r, -1, w2p)
        out[:, c0:c0 + step] = s.amax(dim=-1).sum(dim=1)
    return out


def bilinear_maxsim_scores(qw, pool):
    """bf16 MaxSim: qw (Nq, R, Dp) from ``project_queries``, pool (C, W2P,
    Dp) from ``pack_candidate_pool`` -> (Nq, C) float32.

    CPU tensors: the plain version.  CUDA tensors: the ``maxsim_bf16``
    kernel (Dp a multiple of 16 up to 128)."""
    nq, r, dp = _check_shapes(qw, pool)
    if _on_cpu(qw, pool):
        return bilinear_maxsim_scores_plain(qw, pool)
    _check_cuda_operands(qw=(qw, torch.bfloat16), pool=(pool, torch.bfloat16))
    if dp % 16 or dp > 128:
        raise ValueError(f"maxsim_bf16 takes Dp in 16..128 step 16, got {dp}")
    c, w2p = pool.shape[0], pool.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=qw.device)
    tc, nwarps, qpb = _launch_shape(nq, w2p * (dp + 8) * 2)
    _launch("maxsim_bf16", qw, qw.data_ptr(), pool.data_ptr(),
            out.data_ptr(), nq, r, c, w2p, dp, tc, nwarps, qpb)
    return out


def bilinear_maxsim_scores_reference(q_tokens, cand_tokens, w):
    """Unfused float32 reference: materializes the full similarity map."""
    s = torch.einsum("qid,mde,cje->qmicj", q_tokens, w, cand_tokens)
    return torch.sum(torch.amax(s, dim=-1), dim=(1, 2))


# ---------------------------------------------------------------- int8 path
def _quantize(x, absmax):
    """Symmetric int8 codes: scale = max(absmax, 1e-12) / 127, codes =
    clip(round_half_even(x / scale), -127, 127).  Divides by the scale, as
    the reference does, so the codes come out the same."""
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def pack_candidate_pool_int8(tokens):
    """(C, W2, D) -> (pool_i8 (C, W2P, Dp) int8, aux (C, 2) bf16 with
    lane 0 = per-candidate scale, lane 1 = additive mask)."""
    c, w2, d = tokens.shape
    tokens = tokens.to(torch.float32)
    q, scale = _quantize(tokens, tokens.abs().amax(dim=(1, 2))[:, None, None])
    pool = torch.zeros((c, _round_up(w2, 8), _round_up(d, 32)),
                       dtype=torch.int8, device=tokens.device)
    pool[:, :w2, :d] = q
    pool[:, w2:, :d] = q[:, :1, :]   # a copy of token 0 never changes a max
    aux = torch.zeros((c, 2), dtype=torch.bfloat16, device=tokens.device)
    aux[:, 0] = scale[:, 0, 0].to(torch.bfloat16)
    return pool, aux


def mask_out_candidates_int8(aux, start: int):
    """Mark candidates [start:] as padding (scale 0, additive -1e30), in
    place; returns ``aux``."""
    aux[start:, 0] = 0.0
    aux[start:, 1] = NEG_INF
    return aux


def project_queries_int8(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (qw_i8 (Nq, R, Dp) int8, q_scales (Nq, R)
    float32), one symmetric scale per projected row."""
    qw = _project(q_tokens, w)
    nq, r, d = qw.shape
    q, scale = _quantize(qw, qw.abs().amax(dim=-1, keepdim=True))
    out = torch.zeros((nq, r, _round_up(d, 32)), dtype=torch.int8,
                      device=qw.device)
    out[:, :, :d] = q
    return out, scale[:, :, 0]


def bilinear_maxsim_scores_int8_plain(qw_i8, q_scales, pool_i8, aux):
    """Plain PyTorch version of the int8 kernel: (Nq, C) float32.

    The integer dots run in float32, where they are exact (|dot| <= Dp *
    127^2 < 2^24 for Dp <= 1040).  Then, as in the kernel: max over tokens,
    x the bf16-rounded query-row scale, x the candidate scale, summed over
    rows, + the mask."""
    nq, r, dp = qw_i8.shape
    c, w2p, _ = pool_i8.shape
    a = qw_i8.reshape(nq * r, dp).to(torch.float32)
    sq = q_scales.to(torch.bfloat16).to(torch.float32)[:, :, None]
    sc = aux[:, 0].to(torch.float32)
    mask = aux[:, 1].to(torch.float32)
    out = torch.empty((nq, c), dtype=torch.float32, device=qw_i8.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (nq * r * w2p * 4))
    for c0 in range(0, c, step):
        p = pool_i8[c0:c0 + step].reshape(-1, dp).to(torch.float32)
        m = (a @ p.T).view(nq, r, -1, w2p).amax(dim=-1)
        out[:, c0:c0 + step] = ((m * sq) * sc[c0:c0 + step]).sum(dim=1) \
            + mask[c0:c0 + step]
    return out


def bilinear_maxsim_scores_int8(qw_i8, q_scales, pool_i8, aux):
    """int8 MaxSim: operands from ``project_queries_int8`` and
    ``pack_candidate_pool_int8`` -> (Nq, C) float32 approximate scores.

    The query-row scales are rounded to bf16 here, as the reference does.
    CPU tensors: the plain version.  CUDA tensors: the ``maxsim_int8``
    kernel (Dp a multiple of 32 up to 256)."""
    nq, r, dp = _check_shapes(qw_i8, pool_i8)
    c, w2p = pool_i8.shape[0], pool_i8.shape[1]
    if tuple(q_scales.shape) != (nq, r) or tuple(aux.shape) != (c, 2):
        raise ValueError(f"q_scales {tuple(q_scales.shape)} / aux "
                         f"{tuple(aux.shape)} do not fit qw {tuple(qw_i8.shape)}"
                         f" and pool {tuple(pool_i8.shape)}")
    if _on_cpu(qw_i8, q_scales, pool_i8, aux):
        return bilinear_maxsim_scores_int8_plain(qw_i8, q_scales, pool_i8,
                                                 aux)
    _check_cuda_operands(qw_i8=(qw_i8, torch.int8),
                         q_scales=(q_scales, torch.float32),
                         pool_i8=(pool_i8, torch.int8),
                         aux=(aux, torch.bfloat16))
    if dp % 32 or dp > 256:
        raise ValueError(f"maxsim_int8 takes Dp in 32..256 step 32, got {dp}")
    sq = q_scales.to(torch.bfloat16).to(torch.float32)
    out = torch.empty((nq, c), dtype=torch.float32, device=qw_i8.device)
    tc, nwarps, qpb = _launch_shape(nq, w2p * (dp + 16))
    _launch("maxsim_int8", qw_i8, qw_i8.data_ptr(), sq.data_ptr(),
            pool_i8.data_ptr(), aux.data_ptr(), out.data_ptr(), nq, r, c,
            w2p, dp, tc, nwarps, qpb)
    return out


# ------------------------------------------------------------- launch glue
def _check_shapes(qw, pool):
    if qw.ndim != 3 or pool.ndim != 3 or qw.shape[2] != pool.shape[2]:
        raise ValueError(f"expected qw (Nq, R, Dp) and pool (C, W2P, Dp), "
                         f"got {tuple(qw.shape)} and {tuple(pool.shape)}")
    if 0 in qw.shape or 0 in pool.shape:
        raise ValueError(f"empty operand: qw {tuple(qw.shape)}, pool "
                         f"{tuple(pool.shape)}")
    return qw.shape


def _on_cpu(*tensors) -> bool:
    """True when every operand lies on the CPU (run the plain version);
    False when every operand lies on one CUDA device (launch); raises for
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cpu"


def _check_cuda_operands(align=16, **operands):
    for name, (t, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _launch_shape(nq: int, cand_smem_bytes: int) -> tuple[int, int, int]:
    """(candidates per block, warps per block, queries per block).  A warp
    scores whole queries, so small batches get small blocks with small
    candidate tiles (more blocks resident per SM); a tile is at most 32
    candidates (one per lane) and must fit in shared memory."""
    nwarps = min(8, nq)
    tc = min(16 if nq >= 8 else 4, _SMEM_BYTES // cand_smem_bytes)
    if tc < 1:
        raise ValueError(f"one candidate needs {cand_smem_bytes} bytes of "
                         f"shared memory, more than a block has")
    return tc, nwarps, 64


def _launch(name: str, like: torch.Tensor, *args):
    lib = _build.load_library()
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = getattr(lib, name)(*args, like.device.index or 0, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.maxsim_error_string(err).decode()})")
    LAUNCH_COUNTS[name] += 1
