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
* int4: the int8 layout on the +-7 grid, stored two codes per byte: pool
  (C, W2P, Dp/2) uint8, lane 2i in the low nibble and lane 2i+1 in the
  high one, each 4-bit two's complement.  The candidate scale comes from
  the 99.5th percentile of |value|, not the max.  Queries stay +-7 codes
  in int8 (they are small), with one f32 scale per row.

W2P = round_up(W2, 8) in all three.  The CUDA scorers take any Dp that is
a multiple of 32 bytes (16 bf16 or 32 int8 lanes), any W2P and any R a
block's shared memory can hold the row terms of (rows past 256 bytes, or
query rows that do not fit whole, take the K-sliced plan), so the
reference packers' 128-lane outputs and V4_WIDE's D = 300 score here too.

Each entry point is a wrapper over a hand-written CUDA kernel (``csrc/``).
On CPU tensors the wrapper runs the plain PyTorch version beside it; on
CUDA tensors it launches the kernel or raises.  ``LAUNCH_COUNTS`` counts
kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30

# kernel name -> launches since the counter was last reset
LAUNCH_COUNTS = {"maxsim_bf16": 0, "maxsim_int8": 0, "maxsim_int4": 0,
                 "pair_maps_fwd": 0, "pair_maps_bwd_qa": 0,
                 "pair_maps_bwd_w": 0}

# How far a kernel may stray from its plain version on the same operands.
# MaxSim, as a fraction of the row's largest |score|: int8 and int4, each
# row's term is the same three IEEE float32 products in both, only the
# order of the sum over rows differs; bf16, the tensor cores also
# accumulate each 16-term dot product in their own order and rounding.
# Pair maps, as a fraction of the output's (out, dQ, dA or dW) largest
# |value|: float32 FMAs in both, only the order of the sums over D, W1, W2,
# M and the batch differs; the forward's first product runs as 3xTF32
# (hi and lo TF32 parts, three tensor-core products), whose error is below
# float32's rounding (no single-pass TF32, no reduced precision).
KERNEL_VS_PLAIN_RTOL = {"maxsim_bf16": 1e-4, "maxsim_int8": 1e-5,
                        "maxsim_int4": 1e-5, "pair_maps_fwd": 1e-5,
                        "pair_maps_bwd_qa": 1e-5, "pair_maps_bwd_w": 1e-5}

INT4_BOUND = 7.0
INT4_CLIP_QUANTILE = 0.995  # the reference's candidate-scale percentile

_SMEM_BYTES = 232448   # dynamic shared memory one sm_90 block may use
_PLAIN_CHUNK_BYTES = 1 << 30  # similarity slab the plain versions hold
_GRID_Y = 65535        # largest gridDim.y and gridDim.z of a launch
# the tiling of csrc/pair_maps.cu (its constants of the same names), which
# the launch plans below size threads and shared memory from
_PM_THREADS = 512      # threads per block, at most (MAX_THREADS)
_PM_MS = 4             # measures per block (MS)
_PM_FK = 32            # columns of q_n, rows of W per forward slab (FK)
_PM_STAGES = 2         # slabs in the forward's ring (STAGES)
_PM_MFW = 2            # 16-column fragments of P^T per warp (MFW)
_PM_MAX_ROWS = 40      # rows of q_n per forward block (8 x MAX_NF)
_QA_THREADS = 256      # threads of a dQ / dA block (QA_THREADS)
_QA_ROWS = 128         # rows of x in a dQ / dA block's U, at most (QA_ROWS)
_QA_COLS = 64          # columns of U a block, at most (QA_COLS, wgmma's N)
_SMS = 132             # streaming multiprocessors of an H100 SXM
# the MaxSim plan of csrc/maxsim_wgmma.cuh (constants of the same meaning
# there), which maxsim_geometry sizes shared memory from
_MS_TILE_N = (240, 256)   # wgmma widths the kernels are built for (N)
_MS_MAX_CANDS = 32        # candidates per tile (kMaxCands)
_MS_CONSUMERS = 2         # consumer warpgroups (kConsumers)
_MS_ROW_TILE = 64         # query rows of one wgmma (kRowTile)
_MS_MAX_GROUP = 8         # queries per group, at most
_MS_STAGES = (3, 2, 6)    # pool tiles in the ring: wanted, fewest, most
_MS_WAVES = 32            # units per block the split of the pool aims at


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


class PairMapsFwdGeometry(NamedTuple):
    """Launch of ``pair_maps_fwd``: blocks (N, ceil(W1 / rows) *
    col_tiles * ceil(W2 / w2t), ceil(M / 4)) of ``threads`` threads and
    ``smem`` bytes of dynamic shared memory, each forming P = q_n W_m on
    ``te`` of its columns and out on ``w2t`` of W2's; with ``col_tiles`` >
    1 the blocks write one partial map per column tile, summed in tile
    order."""
    rows: int
    te: int
    col_tiles: int
    threads: int
    smem: int
    w2t: int


class PairMapsDwGeometry(NamedTuple):
    """Launch of ``pair_maps_bwd_w``: one block per panel of ``d_rows`` x
    ``te`` of dW (four measures), per chunk of ``n_per`` samples (the last
    may be shorter) and per four measures; ``chunks`` partials, summed in
    chunk order when there is more than one."""
    n_per: int
    chunks: int
    d_rows: int
    te: int
    threads: int
    smem: int
    w1t: int


class PairMapsQaRole(NamedTuple):
    """One of ``pair_maps_bwd_qa``'s two launches (dQ: K = W2 rows of a_n,
    R = W1 output rows; dA: K = W1 rows of q_n, R = W2): blocks of
    ``samples`` samples (several only with ``k_rows`` = K) x ceil(R /
    ``r_rows``) x column tiles, each forming U = x_n V_m on up to 128 rows
    of x, ``k_rows`` a chunk, and contracting it with G into a 4 x 8 tile
    of the output per thread; ``smem`` bytes of dynamic shared memory."""
    samples: int
    k_rows: int
    r_rows: int
    blocks: int
    smem: int


class PairMapsQaGeometry(NamedTuple):
    """Launch of ``pair_maps_bwd_qa``: output columns ``te`` a block, the
    dQ blocks ``dq`` and the dA blocks ``da`` (one launch), each block
    over ``m_per`` measures: with ceil(M / m_per) > 1 groups, each group
    writes a partial output, summed in group order."""
    te: int
    dq: PairMapsQaRole
    da: PairMapsQaRole
    m_per: int


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


def _check_pair_maps_shape(name: str, n: int, w1: int, w2: int, d: int,
                           m: int) -> None:
    if not (min(n, w1, w2, d) >= 1 and 1 <= m <= _GRID_Y):
        raise ValueError(f"{name} takes N, W1, W2, D >= 1 and 1 <= M <= "
                         f"{_GRID_Y}; got N={n} W1={w1} W2={w2} D={d} M={m}")


def fwd_launch(w2t: int, d: int, rows: int, te: int) -> PairMapsFwdGeometry:
    """The forward's launch for a part of ``rows`` rows of q_n, column
    tiles ``te`` wide and tiles of ``w2t`` of W2: a warp per MFW 16-column
    fragments of P^T, a 2-row x 8-column tile of the second product per
    thread, and ``fwd_smem`` of csrc/pair_maps.cu: STAGES x (q slab
    [R8][FK + 4] + W slab [FK][MS te + 8]) + P tile [te][R8][MS] + a_n^T
    [te][round8(w2t)]."""
    r8, w2p = _round_up(rows, 8), _round_up(w2t, 8)
    threads = _round_up(max(32 * _cdiv(_PM_MS * te // 16, _PM_MFW),
                            r8 // 2 * w2p // 8), 32)
    smem = 4 * (_PM_STAGES * (r8 * (_PM_FK + 4) + _PM_FK * (_PM_MS * te + 8))
                + te * r8 * _PM_MS + te * w2p)
    return PairMapsFwdGeometry(rows, te, _cdiv(d, te), threads, smem, w2t)


def dw_launch(n: int, w1t: int, w2: int, d: int, n_per: int, d_rows: int,
              te: int) -> PairMapsDwGeometry:
    """dW's launch for chunks of ``n_per`` samples, W1 tiles of ``w1t``
    rows and panels of ``d_rows`` x ``te``: an 8 x 8 tile of the panel per
    thread for each of the MS measures, and ``bwd_w_smem`` of
    csrc/pair_maps.cu: 2 x (q rows [w1t][DR8] + G_n rows [w1t][W2][MS] +
    a_n slice [W2][te]) + t [w1t][MS][te]."""
    dr8 = _round_up(d_rows, 8)
    threads = _round_up(dr8 // 8 * (te // 8) * _PM_MS, 32)
    smem = 4 * (2 * (w1t * dr8 + w1t * w2 * _PM_MS + w2 * te)
                + w1t * _PM_MS * te)
    return PairMapsDwGeometry(n_per, _cdiv(n, n_per), d_rows, te, threads,
                              smem, w1t)


def qa_launch(n: int, kn: int, rn: int, d: int, samples: int, k_rows: int,
              r_rows: int, te: int) -> PairMapsQaRole:
    """A dQ or dA launch: blocks and ``qa_smem`` of csrc/pair_maps.cu: 1 KB
    to align, STAGES raw slabs and one of their low TF32 parts, each
    (x's 64 or 128 rows + 64 rows of W_m) x 128 bytes, which U reuses, + 2
    x G [samples x k_rows][4 ceil(r_rows / 4)]."""
    rows = 64 if samples * k_rows <= 64 else _QA_ROWS
    slab = (rows + _QA_COLS) * _PM_FK * 4
    smem = 1024 + (_PM_STAGES + 1) * slab \
        + 2 * 4 * samples * k_rows * 4 * _cdiv(r_rows, 4)
    blocks = _cdiv(n, samples) * _cdiv(rn, r_rows) * _cdiv(d, te)
    return PairMapsQaRole(samples, k_rows, r_rows, blocks, smem)


@functools.lru_cache(maxsize=256)
def pair_maps_fwd_geometry(n: int, w1: int, w2: int, d: int,
                           m: int) -> PairMapsFwdGeometry:
    """The launch of ``pair_maps_fwd`` for one shape, from the shape alone.
    P's columns: as few tiles of at most 64 as cover D, equal in width
    (several write partial maps).  W2: one tile while 40 rows' second
    product fits 512 threads (W2 <= 200), else as few equal tiles as fit
    (each forms its P again).  W1's rows: parts of at most 40 (the
    kernel's row fragments), split in two again, down to 8 rows, while the
    grid, doubled, still fits one wave of the 132 SMs.  Every plan fits:
    at most 512 threads and 184,320 bytes of shared memory.  Raises
    ValueError for a shape the kernel does not take."""
    _check_pair_maps_shape("pair_maps_fwd", n, w1, w2, d, m)
    te = _round_up(_cdiv(d, _cdiv(d, 64)), 8)
    rows = min(w1, _PM_MAX_ROWS)
    w2_tiles = next(t for t in range(1, w2 + 1)
                    if (geo := fwd_launch(_cdiv(w2, t), d, rows, te)).threads
                    <= _PM_THREADS and geo.smem <= _SMEM_BYTES)
    w2t = _cdiv(w2, w2_tiles)
    blocks = n * _cdiv(d, te) * _cdiv(m, _PM_MS) * _cdiv(w2, w2t)
    parts = _cdiv(w1, _PM_MAX_ROWS)
    while 2 * parts * blocks <= _SMS and _cdiv(w1, 2 * parts) >= 8:
        parts *= 2
    geo = fwd_launch(w2t, d, _cdiv(w1, parts), te)
    if _cdiv(w1, geo.rows) * geo.col_tiles * _cdiv(w2, w2t) > _GRID_Y:
        raise ValueError(f"pair_maps_fwd: W1={w1} x W2={w2} x D={d} needs "
                         f"more blocks than a grid dimension holds")
    return geo


@functools.lru_cache(maxsize=256)
def pair_maps_bwd_w_geometry(n: int, w1: int, w2: int, d: int,
                             m: int) -> PairMapsDwGeometry:
    """The launch of ``pair_maps_bwd_w`` for one shape, from the shape
    alone.  A sample's W1 rows in one tile where a panel fits at some split
    of D, else in as few equal tiles as let one fit at the fewest splits
    (G_n is staged a tile at a time; the sums over W1 keep their row
    order).  A panel spans all of D's rows, split only where no panel fits
    (t = G_m a_n is then formed once per split), and the widest column slice (a multiple of 8, at most 64) that
    fits 512 threads and the shared memory; narrowed to at least 132 // (N
    x row splits x measure groups) slices, so that a small batch's panels
    fill a wave; then ceil(132 / panels) chunks of samples (at most N),
    which cover 0..N exactly, none empty.  Raises ValueError for a shape
    the kernel does not take."""
    _check_pair_maps_shape("pair_maps_bwd_w", n, w1, w2, d, m)
    # W1 whole at any split of D first (every plan of W <= 64 is such),
    # else W1 tiles before further splits of D
    splits_all = range(1, _cdiv(d, 8) + 1)
    tries = [(1, sp) for sp in splits_all] + [
        (t, sp) for sp in splits_all for t in range(2, w1 + 1)]
    te = None
    for w1_tiles, splits in tries:
        w1t, d_rows = _cdiv(w1, w1_tiles), _cdiv(d, splits)
        te = next((t for t in range(min(64, _round_up(d, 8)), 0, -8)
                   if (geo := dw_launch(n, w1t, w2, d, n, d_rows, t)).threads
                   <= _PM_THREADS and geo.smem <= _SMEM_BYTES), None)
        if te is not None:
            break
    if te is None:
        raise ValueError(f"pair_maps_bwd_w: no panel fits W2={w2}")
    row_parts, groups = _cdiv(d, d_rows), _cdiv(m, _PM_MS)
    e_tiles = max(_cdiv(d, te),
                  min(_cdiv(d, 8), _SMS // (n * row_parts * groups)))
    te = _round_up(_cdiv(d, e_tiles), 8)
    panels = row_parts * _cdiv(d, te) * groups
    n_per = _cdiv(n, min(n, _cdiv(_SMS, panels)))
    return dw_launch(n, w1t, w2, d, n_per, d_rows, te)


def _qa_role(n: int, kn: int, rn: int, d: int, te: int) -> PairMapsQaRole:
    """A dQ or dA launch before the grid is filled: x's rows of as many
    whole samples as make at most 128 (one sample in equal chunks where K
    is larger), then as many output rows as the 256 threads' 4 x 8 tiles
    cover (R in equal tiles where they do not, or where G's tile would
    not fit shared memory), fewer samples where not even 4 rows of each
    fit."""
    if kn <= _QA_ROWS:
        k_rows, samples = kn, min(n, _QA_ROWS // kn)
    else:
        k_rows, samples = _cdiv(kn, _cdiv(kn, _QA_ROWS)), 1
    col_groups = te // 8
    samples = max(1, min(samples, _QA_THREADS // (col_groups
                                                  * _cdiv(rn, 4))))
    r_tiles = _cdiv(rn, min(rn, 4 * (_QA_THREADS // (col_groups
                                                     * samples))))
    while (role := qa_launch(n, kn, rn, d, samples, k_rows,
                             _cdiv(rn, r_tiles), te)).smem \
            > _SMEM_BYTES:       # G's tile too large: more row tiles
        r_tiles += 1
    return role


@functools.lru_cache(maxsize=256)
def pair_maps_bwd_qa_geometry(n: int, w1: int, w2: int, d: int,
                              m: int) -> PairMapsQaGeometry:
    """The launch of ``pair_maps_bwd_qa`` for one shape, from the shape
    alone.  Output columns: as few tiles of at most 64 as cover D, equal in
    width.  For dQ (x = a_n, K = W2, R = W1) and dA (x = q_n, K = W1, R =
    W2) each: the rows of x of as many whole samples as make at most 128
    (V4's 40: three samples a block; past 128, one sample in equal
    chunks), the output rows the 256 threads' 4-row x 8-column tiles cover
    (equal tiles of R where they do not); then, while both launches'
    blocks, doubled, still fit one wave of the 132 SMs, half the samples a
    block; and where the two launches' blocks still fill less than two a
    SM, the measures in as many groups as make them do (each group a
    partial output).  Every plan fits 256 threads and a block's shared
    memory.  Raises ValueError for a shape the kernel does not take."""
    _check_pair_maps_shape("pair_maps_bwd_qa", n, w1, w2, d, m)
    te = _round_up(_cdiv(d, _cdiv(d, 64)), 8)
    dq, da = _qa_role(n, w2, w1, d, te), _qa_role(n, w1, w2, d, te)
    while 2 * (dq.blocks + da.blocks) <= _SMS \
            and max(dq.samples, da.samples) > 1:
        dq = qa_launch(n, w2, w1, d, _cdiv(dq.samples, 2), dq.k_rows,
                       dq.r_rows, te)
        da = qa_launch(n, w1, w2, d, _cdiv(da.samples, 2), da.k_rows,
                       da.r_rows, te)
    if max(_cdiv(w1, dq.r_rows), _cdiv(w2, da.r_rows)) * _cdiv(d, te) \
            > _GRID_Y:
        raise ValueError(f"pair_maps_bwd_qa: W1={w1} x W2={w2} x D={d} needs"
                         f" more blocks than a grid dimension holds")
    groups = min(m, _cdiv(2 * _SMS, dq.blocks + da.blocks))
    return PairMapsQaGeometry(te, dq, da, _cdiv(m, groups))


def pair_maps_fwd(q, a, w):
    """The forward map (N, W1, W2, M): the ``pair_maps_fwd`` kernel on CUDA
    tensors, ``bilinear_pair_maps_plain`` on CPU tensors."""
    n, w1, w2, d, m = _pair_maps_shapes(q, a, w)
    if _on_cpu(q, a, w):
        return bilinear_pair_maps_plain(q, a, w)
    _check_pair_maps_cuda(q, a, w)
    geo = pair_maps_fwd_geometry(n, w1, w2, d, m)
    out = torch.empty((n, w1, w2, m), dtype=torch.float32, device=q.device)
    part = torch.empty((geo.col_tiles, n, w1, w2, m), dtype=torch.float32,
                       device=q.device) if geo.col_tiles > 1 else out
    _launch("pair_maps_fwd", q, q.data_ptr(), a.data_ptr(), w.data_ptr(),
            out.data_ptr(), part.data_ptr(), n, w1, w2, d, m, geo.rows,
            geo.te, geo.w2t, geo.threads)
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
    geo = pair_maps_bwd_qa_geometry(n, w1, w2, d, m)
    out = torch.empty(n * (w1 + w2) * d, dtype=torch.float32,
                      device=q.device)
    groups = _cdiv(m, geo.m_per)
    part = torch.empty((groups, out.numel()), dtype=torch.float32,
                       device=q.device) if groups > 1 else out
    _launch("pair_maps_bwd_qa", q, q.data_ptr(), a.data_ptr(), w.data_ptr(),
            g.data_ptr(), out.data_ptr(), part.data_ptr(), n, w1, w2, d, m,
            geo.te, geo.m_per, *geo.dq[:3], *geo.da[:3])
    return (out[:n * w1 * d].view(n, w1, d),
            out[n * w1 * d:].view(n, w2, d))


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
    geo = pair_maps_bwd_w_geometry(n, w1, w2, d, m)
    dw = torch.empty_like(w)
    part = torch.empty((geo.chunks,) + tuple(w.shape), dtype=torch.float32,
                       device=w.device) if geo.chunks > 1 else dw
    _launch("pair_maps_bwd_w", q, q.data_ptr(), a.data_ptr(), g.data_ptr(),
            dw.data_ptr(), part.data_ptr(), n, w1, w2, d, m, geo.n_per,
            geo.d_rows, geo.te, geo.w1t, geo.threads)
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

    CUDA operands must be contiguous float32 with M <= 65535; any W1, W2
    and D are taken (they are tiled)."""
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
    _check_pair_maps_shape("the pair-map kernels", n, w1, w2, d, m)
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


def mask_candidate_rows(pool, rows):
    """Mark the given candidate rows as padding (tombstones), in place;
    returns ``pool``."""
    pool[rows, :, -1] = NEG_INF
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
    kernel (any Dp that is a multiple of 16)."""
    nq, r, dp = _check_shapes(qw, pool)
    if _on_cpu(qw, pool):
        return bilinear_maxsim_scores_plain(qw, pool)
    _check_cuda_operands(qw=(qw, torch.bfloat16), pool=(pool, torch.bfloat16))
    c, w2p = pool.shape[0], pool.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=qw.device)
    geo = maxsim_geometry(nq, r, c, w2p, dp, "bf16")
    _launch("maxsim_bf16", qw, qw.data_ptr(), pool.data_ptr(),
            out.data_ptr(), nq, r, c, w2p, dp, *_plan_args(geo))
    return out


def bilinear_maxsim_scores_reference(q_tokens, cand_tokens, w):
    """Unfused float32 reference: materializes the full similarity map."""
    s = torch.einsum("qid,mde,cje->qmicj", q_tokens, w, cand_tokens)
    return torch.sum(torch.amax(s, dim=-1), dim=(1, 2))


# ---------------------------------------------------------------- int8 path
def _quantize(x, absmax, bound: float = 127.0):
    """Symmetric int8 codes: scale = max(absmax, 1e-12) / bound, codes =
    clip(round_half_even(x / scale), -bound, bound).  Divides by the scale,
    as the reference does, so the codes come out the same."""
    scale = torch.clamp(absmax, min=1e-12) / bound
    codes = torch.clamp(torch.round(x / scale), -bound, bound)
    return codes.to(torch.int8), scale


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


def mask_candidate_rows_int8(aux, rows):
    """Mark the given candidate rows as padding (tombstones: scale 0,
    additive -1e30), in place; returns ``aux``."""
    aux[rows, 0] = 0.0
    aux[rows, 1] = NEG_INF
    return aux


def project_queries_int8(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (qw_i8 (Nq, R, Dp) int8, q_scales (Nq, R)
    float32), one symmetric scale per projected row."""
    return _project_quantized(q_tokens, w, 127.0)


def _project_quantized(q_tokens, w, bound: float):
    qw = _project(q_tokens, w)
    nq, r, d = qw.shape
    q, scale = _quantize(qw, qw.abs().amax(dim=-1, keepdim=True), bound)
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
    kernel (any Dp that is a multiple of 32)."""
    return _maxsim_quantized("maxsim_int8", bilinear_maxsim_scores_int8_plain,
                             torch.int8, 1, qw_i8, q_scales, pool_i8, aux)


def _maxsim_quantized(name, plain, pool_dtype, lanes_per_byte, qw,
                      q_scales, pool, aux):
    """The int8 and int4 wrappers: checks, then the plain version on CPU
    tensors or kernel ``name`` on CUDA ones (the staged tile is int8 in
    both, so they share a launch plan)."""
    nq, r, dp = _check_shapes(qw, pool, lanes_per_byte)
    c, w2p = pool.shape[0], pool.shape[1]
    if tuple(q_scales.shape) != (nq, r) or tuple(aux.shape) != (c, 2):
        raise ValueError(f"q_scales {tuple(q_scales.shape)} / aux "
                         f"{tuple(aux.shape)} do not fit qw {tuple(qw.shape)}"
                         f" and pool {tuple(pool.shape)}")
    if _on_cpu(qw, q_scales, pool, aux):
        return plain(qw, q_scales, pool, aux)
    _check_cuda_operands(qw=(qw, torch.int8),
                         q_scales=(q_scales, torch.float32),
                         pool=(pool, pool_dtype),
                         aux=(aux, torch.bfloat16))
    sq = q_scales.to(torch.bfloat16).to(torch.float32)
    out = torch.empty((nq, c), dtype=torch.float32, device=qw.device)
    geo = maxsim_geometry(nq, r, c, w2p, dp, name[-4:])
    _launch(name, qw, qw.data_ptr(), sq.data_ptr(), pool.data_ptr(),
            aux.data_ptr(), out.data_ptr(), nq, r, c, w2p, dp,
            *_plan_args(geo))
    return out


# ---------------------------------------------------------------- int4 path
def _fma_f32(a, b, c):
    """round_f32(a * b + c) with one rounding, for float32 tensors: the
    product is exact in float64, the sum is rounded to odd there (TwoSum
    gives its error), and the float64 -> float32 cast then rounds as a
    fused multiply-add would."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(inexact_even, torch.nextafter(s, away), s).float()


def _quantile_rows(x, q: float):
    """Per-row quantile of (C, n) float32 values, as ``jnp.quantile``'s
    linear method computes it on XLA's CPU backend: position q * (n - 1)
    in float32, w = position - floor(position), then low * (1 - w) fused
    into the add of high * w (rounded on its own).  The two order
    statistics come from a top-k of the row's largest values (a partial
    sort), which takes any number of elements."""
    n = x.shape[1]
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(
        n - 1, dtype=torch.float32)
    lo = min(max(int(torch.floor(pos)), 0), n - 1)
    hi = min(max(int(torch.ceil(pos)), 0), n - 1)
    w_hi = pos - torch.floor(pos)
    w_lo = torch.tensor(1.0, dtype=torch.float32) - w_hi
    # the (n - lo) largest values, descending: the last one is order
    # statistic lo, the one before it order statistic hi
    top = torch.topk(x, n - lo, dim=1, sorted=True).values
    low_v, high_v = top[:, n - lo - 1], top[:, n - hi - 1]
    return _fma_f32(low_v, w_lo.to(x.device), high_v * w_hi.to(x.device))


def pack_int4(codes):
    """(..., Dp) int8 codes in [-8, 7], Dp even -> (..., Dp/2) uint8: lane
    2i in the low nibble, lane 2i+1 in the high nibble."""
    u = codes.to(torch.uint8) & 0x0F
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(packed):
    """Inverse of ``pack_int4``: (..., Dp/2) uint8 -> (..., Dp) int8, each
    nibble sign-extended ((n ^ 8) - 8)."""
    lo = ((packed & 0x0F).to(torch.int8) ^ 8) - 8
    hi = ((packed >> 4).to(torch.int8) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def pack_candidate_pool_int4(tokens, clip_quantile: float | None
                             = INT4_CLIP_QUANTILE):
    """(C, W2, D) -> (pool_i4 (C, W2P, Dp/2) uint8, aux (C, 2) bf16 with
    lane 0 = per-candidate scale, lane 1 = additive mask).

    scale = max(quantile(|tokens of c|, clip_quantile), 1e-12) / 7 (the
    max when ``clip_quantile`` is None), codes clip(round(x / scale), -7,
    7), padded token rows duplicating token 0, as the reference packs them.
    Capacity-only, as in the reference: about 0.6 top-10 agreement with
    bf16, so serve it behind ``query_rerank``."""
    c, w2, d = tokens.shape
    tokens = tokens.to(torch.float32)
    mags = tokens.abs().reshape(c, w2 * d)
    absmax = (mags.amax(dim=1) if clip_quantile is None
              else _quantile_rows(mags, clip_quantile))
    q, scale = _quantize(tokens, absmax[:, None, None], INT4_BOUND)
    codes = torch.zeros((c, _round_up(w2, 8), _round_up(d, 32)),
                        dtype=torch.int8, device=tokens.device)
    codes[:, :w2, :d] = q
    codes[:, w2:, :d] = q[:, :1, :]
    aux = torch.zeros((c, 2), dtype=torch.bfloat16, device=tokens.device)
    aux[:, 0] = scale[:, 0, 0].to(torch.bfloat16)
    return pack_int4(codes), aux


def project_queries_int4(q_tokens, w):
    """(Nq, W1, D) x (M, D, D) -> (qw (Nq, R, Dp) int8 codes in [-7, 7],
    q_scales (Nq, R) float32), one symmetric scale per projected row."""
    return _project_quantized(q_tokens, w, INT4_BOUND)


# the aux layout is int8's, so masking is too
mask_out_candidates_int4 = mask_out_candidates_int8
mask_candidate_rows_int4 = mask_candidate_rows_int8


def bilinear_maxsim_scores_int4_plain(qw_i4, q_scales, pool_i4, aux):
    """Plain PyTorch version of the int4 kernel: the nibbles unpacked, then
    the int8 plain version, which is exact on +-7 codes."""
    return bilinear_maxsim_scores_int8_plain(qw_i4, q_scales,
                                             unpack_int4(pool_i4), aux)


def bilinear_maxsim_scores_int4(qw_i4, q_scales, pool_i4, aux):
    """int4 MaxSim: operands from ``project_queries_int4`` and
    ``pack_candidate_pool_int4`` -> (Nq, C) float32 approximate scores.

    CPU tensors: the plain version.  CUDA tensors: the ``maxsim_int4``
    kernel (any Dp that is a multiple of 32, so Dp/2 packed bytes per
    token); its scores equal the ``maxsim_int8`` kernel's on the unpacked
    codes, bit for bit."""
    return _maxsim_quantized("maxsim_int4", bilinear_maxsim_scores_int4_plain,
                             torch.uint8, 2, qw_i4, q_scales, pool_i4, aux)


# ------------------------------------------------------------- launch glue
def _check_shapes(qw, pool, lanes_per_byte: int = 1):
    """(Nq, R, Dp) of qw against a pool (C, W2P, Dp / lanes_per_byte)."""
    if qw.ndim != 3 or pool.ndim != 3 \
            or qw.shape[2] != pool.shape[2] * lanes_per_byte:
        raise ValueError(f"expected qw (Nq, R, Dp) and pool (C, W2P, "
                         f"Dp/{lanes_per_byte}), got {tuple(qw.shape)} and "
                         f"{tuple(pool.shape)}")
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


class MaxSimGeometry(NamedTuple):
    """Launch of a MaxSim kernel: ``grid`` persistent blocks walk ``units``
    = ``n_groups`` query groups of ``g`` queries x ranges of
    ``tiles_per_unit`` pool tiles (unit u: group u % n_groups, range u //
    n_groups); a tile is ``n_c`` whole candidates in one ``n``-column
    wgmma, or, where a candidate has more than 256 tokens, one of its
    ``slabs`` parts of ``w2s`` tokens; ``stages`` slots in the ring;
    ``smem`` bytes of dynamic shared memory.  ``k_sliced``: the group's
    query rows are not resident; each slot holds one K span of a tile and
    of a 64-row tile of query rows, half the slots for each consumer."""
    g: int
    n_c: int
    w2s: int
    slabs: int
    n: int
    stages: int
    tiles_per_unit: int
    n_groups: int
    n_tiles: int
    units: int
    grid: int
    smem: int
    k_sliced: bool


def maxsim_span(row_bytes: int) -> int:
    """The K span (swizzle width) of a row of ``row_bytes``: 128 bytes when
    they divide the row or the row is longer than 256 bytes (whose last
    span then runs past Dp into zeros), else 64 or 32."""
    if row_bytes % 128 == 0 or row_bytes > 256:
        return 128
    return 64 if row_bytes % 64 == 0 else 32


def maxsim_smem(r: int, dp: int, dtype: str, g: int, n_c: int, n: int,
                stages: int, k_sliced: bool) -> int:
    """Dynamic shared memory of a MaxSim plan, as ``make_plan`` of
    csrc/maxsim_wgmma.cuh lays it out: the ring (resident: tiles of n
    token rows, each rounded to 1 KB, then the group's query rows in
    64-row tiles; K-sliced: slots of one K span of n token rows, rounded to
    1 KB, and of 64 query rows, rounded to 1 KB), for each consumer a (row,
    candidate) term buffer (pitch n_c | 1) and, for int8 and int4, a
    buffer of row scales, the mbarriers and 1 KB to align."""
    row_bytes = dp * (2 if dtype == "bf16" else 1)
    rows = _round_up(g * r, _MS_ROW_TILE)
    if k_sliced:
        kc = maxsim_span(row_bytes)
        ring = stages * _round_up(_round_up(n * kc, 1024)
                                  + _MS_ROW_TILE * kc, 1024)
    else:
        ring = stages * _round_up(n * row_bytes, 1024) + rows * row_bytes
    return (1024 + ring + _MS_CONSUMERS * rows * (n_c | 1) * 4
            + (0 if dtype == "bf16" else _MS_CONSUMERS * rows * 4)
            + (2 * stages + 2) * 8)


def _maxsim_fits(r, w2s, slabs, nq, dp, dtype, k_sliced):
    """Every (n, n_c, g, stages) that fits shared memory, best first: the
    tile width holding the most whole slabs (the narrower on a tie), the
    most candidates, then (at the wanted ring depth, else the fewest) the
    largest group and the deepest ring."""
    if k_sliced:   # two slots a consumer at least, three at most
        stage_opts, most, step = (4,), 6, 2
    else:
        stage_opts, most, step = _MS_STAGES[:2], _MS_STAGES[2], 1
    return [(n, n_c, g, s)
            for n in sorted(_MS_TILE_N, key=lambda n: (-(n // w2s * w2s), n))
            for n_c in range(min(_MS_MAX_CANDS, n // w2s) if slabs == 1
                             else 1, 0, -1)
            for least in stage_opts
            for g in range(min(nq, _MS_MAX_GROUP), 0, -1)
            for s in range(most, least - 1, -step)
            if maxsim_smem(r, dp, dtype, g, n_c, n, s, k_sliced)
            <= _SMEM_BYTES]


@functools.lru_cache(maxsize=256)
def maxsim_geometry(nq: int, r: int, c: int, w2p: int, dp: int,
                    dtype: str) -> MaxSimGeometry:
    """The launch of a MaxSim kernel (``dtype`` "bf16", "int8" or "int4")
    for one shape, from the shape alone.  A candidate's W2P tokens are one
    slab up to 256, else slabs of the largest multiple of 8 up to 256 that
    divides W2P.  The tile width n is the one of 240 and 256 that holds
    the most whole slabs (the narrower on a tie; the other where nothing
    fits), n_c = n // W2S of them (at most 32; fewer only where nothing
    else fits); at W2P = 40 (V4's answers) six whole candidates fill 240
    columns, and the kernel has a path of its own for them.  Rows of at
    most 256 bytes keep the group's query rows resident: groups of up to 8
    queries, the most that leave room for 3 tiles in the ring (2 where no
    group does); then as many tiles as fit, up to 6.  Longer rows, or
    query rows that do not fit beside a 2-tile ring (R = 800 at D = 300),
    take the K-sliced plan: 4 to 6 slots of one 128-byte K span each,
    groups as large as fit.  The pool's tiles split into ranges so that
    there are about 32 units per block of one wave (at least a tile a
    range for each consumer), and the grid is at most one block per SM.
    Raises ValueError for a shape no plan covers: Dp not a multiple of 32
    bytes, or R so large that one query's row terms do not fit beside the
    smallest ring (past about 9,400 rows at bf16's Dp 304, 4,700 at int8's
    Dp 320)."""
    es = 2 if dtype == "bf16" else 1
    if not (nq >= 1 and r >= 1 and c >= 1 and w2p >= 8 and w2p % 8 == 0
            and dp * es >= 32 and dp * es % 32 == 0):
        raise ValueError(f"no MaxSim plan for Nq={nq} R={r} C={c} W2P={w2p}"
                         f" Dp={dp} ({dtype})")
    w2s = w2p if w2p <= 256 else 8 * max(
        d for d in range(1, 33) if (w2p // 8) % d == 0)
    slabs = w2p // w2s
    k_sliced = dp * es > 256
    fits = [] if k_sliced else _maxsim_fits(r, w2s, slabs, nq, dp, dtype,
                                            False)
    if not fits:
        k_sliced = True
        fits = _maxsim_fits(r, w2s, slabs, nq, dp, dtype, True)
    if not fits:
        raise ValueError(f"R={r} query rows need more shared memory than a "
                         f"block has (Dp={dp}, {dtype})")
    n, n_c, g, stages = fits[0]
    n_groups, n_tiles = _cdiv(nq, g), _cdiv(c, n_c)
    per = min(n_tiles, max(_MS_CONSUMERS,
                           _cdiv(n_tiles * n_groups, _SMS * _MS_WAVES)))
    units = n_groups * _cdiv(n_tiles, per)
    return MaxSimGeometry(g, n_c, w2s, slabs, n, stages, per, n_groups,
                          n_tiles, units, min(_SMS, units),
                          maxsim_smem(r, dp, dtype, g, n_c, n, stages,
                                      k_sliced), k_sliced)


def _plan_args(geo: MaxSimGeometry) -> tuple[int, ...]:
    """The plan as the C entry points take it, after (..., dp)."""
    return (geo.g, geo.n_c, geo.w2s, geo.n, geo.stages, geo.tiles_per_unit,
            geo.grid, int(geo.k_sliced))


def _launch(name: str, like: torch.Tensor, *args):
    lib = _build.load_library()
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = getattr(lib, name)(*args, like.device.index or 0, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.maxsim_error_string(err).decode()})")
    LAUNCH_COUNTS[name] += 1
