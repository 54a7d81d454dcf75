"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: ``KERNEL_VS_PLAIN_RTOL`` of the row's max |score| (reasons
beside its definition in ``ops/sim_cross_kernels.py``); masked int8 and
int4 candidates must score the mask exactly; the int4 kernel must give the
int8 kernel's bits on the unpacked codes, and chunked scoring, IVF
probe-all and a reloaded index the unchunked engine's bits (each pair's
score is computed alone, whatever the launch shape).
"""

import contextlib
import dataclasses

import pytest
import torch

from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as T
from mms_answer_selection_tpu_torch.serve import QueryEngine, topk

pytestmark = pytest.mark.cuda

# (Nq, C, W2, W1, M, D): ragged pools and token counts, R below, at and
# above a 32-row step, query batches past one block, and Dp = 128
SHAPES = [(1, 300, 40, 40, 4, 50), (3, 37, 37, 5, 4, 50),
          (9, 1000, 40, 3, 4, 50), (33, 129, 16, 8, 4, 50),
          (70, 200, 40, 40, 4, 50), (5, 64, 24, 6, 2, 100),
          # the image pool of configs[4]: 25 patch tokens (W2P = 32), R = 24
          (16, 8229, 25, 12, 2, 50)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, nq, c, w2, w1, m, d):
    g = torch.Generator(device=dev).manual_seed(nq * 1000 + c)
    q = torch.randn((nq, w1, d), generator=g, device=dev) * 0.3
    cand = torch.randn((c, w2, d), generator=g, device=dev) * 0.3
    w = torch.randn((m, d, d), generator=g, device=dev) * 0.05
    return q, cand, w


def _assert_close(got, want, rtol):
    row_max = want.abs().amax(dim=1, keepdim=True)
    rel = float(((got - want).abs() / row_max).max())
    assert rel <= rtol, rel


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_kernel_matches_plain(shape):
    dev = _cuda()
    q, cand, w = _operands(dev, *shape)
    qw, pool = T.project_queries(q, w), T.pack_candidate_pool(cand)
    n0 = T.LAUNCH_COUNTS["maxsim_bf16"]
    got = T.bilinear_maxsim_scores(qw, pool)
    torch.cuda.synchronize()
    assert T.LAUNCH_COUNTS["maxsim_bf16"] == n0 + 1
    assert got.shape == (shape[0], shape[1])
    _assert_close(got, T.bilinear_maxsim_scores_plain(qw, pool),
                  T.KERNEL_VS_PLAIN_RTOL["maxsim_bf16"])


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_kernel_matches_plain(shape):
    dev = _cuda()
    q, cand, w = _operands(dev, *shape)
    qi, qs = T.project_queries_int8(q, w)
    pool, aux = T.pack_candidate_pool_int8(cand)
    c = shape[1]
    aux = T.mask_out_candidates_int8(aux, c - 2)
    n0 = T.LAUNCH_COUNTS["maxsim_int8"]
    got = T.bilinear_maxsim_scores_int8(qi, qs, pool, aux)
    torch.cuda.synchronize()
    assert T.LAUNCH_COUNTS["maxsim_int8"] == n0 + 1
    want = T.bilinear_maxsim_scores_int8_plain(qi, qs, pool, aux)
    _assert_close(got[:, :c - 2], want[:, :c - 2],
                  T.KERNEL_VS_PLAIN_RTOL["maxsim_int8"])
    assert torch.equal(got[:, c - 2:], want[:, c - 2:])


@pytest.mark.parametrize("shape", SHAPES)
def test_int4_kernel_matches_plain_and_int8_kernel(shape):
    dev = _cuda()
    q, cand, w = _operands(dev, *shape)
    qi, qs = T.project_queries_int4(q, w)
    pool, aux = T.pack_candidate_pool_int4(cand)
    c = shape[1]
    aux = T.mask_candidate_rows_int4(aux, torch.tensor([0, c - 1],
                                                       device=dev))
    n0 = dict(T.LAUNCH_COUNTS)
    got = T.bilinear_maxsim_scores_int4(qi, qs, pool, aux)
    torch.cuda.synchronize()
    assert T.LAUNCH_COUNTS["maxsim_int4"] == n0["maxsim_int4"] + 1
    want = T.bilinear_maxsim_scores_int4_plain(qi, qs, pool, aux)
    _assert_close(got[:, 1:c - 1], want[:, 1:c - 1],
                  T.KERNEL_VS_PLAIN_RTOL["maxsim_int4"])
    assert torch.equal(got[:, [0, c - 1]], want[:, [0, c - 1]])
    as_int8 = T.bilinear_maxsim_scores_int8(qi, qs, T.unpack_int4(pool), aux)
    assert torch.equal(got, as_int8)


def _scorer(dtype, q, cand, w):
    """(kernel, plain, operands) of one dtype for queries q and candidates
    cand under the metric w."""
    if dtype == "bf16":
        return (T.bilinear_maxsim_scores, T.bilinear_maxsim_scores_plain,
                (T.project_queries(q, w), T.pack_candidate_pool(cand)))
    if dtype == "int8":
        return (T.bilinear_maxsim_scores_int8,
                T.bilinear_maxsim_scores_int8_plain,
                (*T.project_queries_int8(q, w),
                 *T.pack_candidate_pool_int8(cand)))
    return (T.bilinear_maxsim_scores_int4,
            T.bilinear_maxsim_scores_int4_plain,
            (*T.project_queries_int4(q, w), *T.pack_candidate_pool_int4(cand)))


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_a_pairs_score_does_not_depend_on_the_launch_shape(dtype):
    """One (query, candidate) pair scored with the query alone and at
    positions 0, 1 and 3 of a batch of 5, the candidate at offsets 0, 1
    and tile - 1 of pools of 1, tile - 1, tile + 1 and 8,192 + 37
    candidates: the same bits every time, within the tolerance of the
    plain version."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((1, 40, 50), generator=g, device=dev) * 0.3
    y = torch.randn((1, 40, 50), generator=g, device=dev) * 0.3
    w = torch.randn((4, 50, 50), generator=g, device=dev) * 0.05
    others = torch.randn((4, 40, 50), generator=g, device=dev) * 0.3
    tile = T.maxsim_geometry(5, 160, 8192, 40, 64, dtype).n_c
    batches = [(x, 0)] + [(torch.cat([others[:i], x, others[i:]]), i)
                          for i in (0, 1, 3)]
    seen = []
    for c in (1, tile - 1, tile + 1, 8192 + 37):
        filler = torch.randn((c, 40, 50), generator=g, device=dev) * 0.3
        for off in {0, 1, tile - 1} & set(range(c)):
            cand = filler.clone()
            cand[off] = y[0]
            for q, pos in batches:
                kernel, plain, args = _scorer(dtype, q, cand, w)
                got = kernel(*args)
                torch.cuda.synchronize()
                seen.append(got[pos, off].view(1))
                if c > 1 and pos in (0, 3):
                    _assert_close(got, plain(*args),
                                  T.KERNEL_VS_PLAIN_RTOL["maxsim_" + dtype])
    seen = torch.cat(seen)
    assert len(seen) >= 30 and torch.equal(seen, seen[:1].expand_as(seen))


# Dp at the ends of the resident plan and past it (V4_WIDE's D = 300: Dp
# 304 bf16, 320 int8 and int4, K-sliced, the last 128-byte span past Dp),
# at W2P = 8, 24 and 40 (W2 = 8, 21 and 37: padded tokens too); D sets Dp
# (bf16: D + 1 rounded to 16; int8 and int4: D rounded to 32)
DP_SHAPES = [(dtype, d, w2) for dtype, ds in (("bf16", (15, 127, 300)),
                                              ("int8", (20, 256, 300)),
                                              ("int4", (20, 256, 300)))
             for d in ds for w2 in (8, 21, 37)]


@pytest.mark.parametrize("shape", DP_SHAPES)
def test_every_dp_and_w2p_the_wrappers_take(shape):
    dtype, d, w2 = shape
    dev = _cuda()
    q, cand, w = _operands(dev, 7, 301, w2, 40, 4, d)
    kernel, plain, args = _scorer(dtype, q, cand, w)
    if dtype != "bf16":
        args = (*args[:3], T.mask_candidate_rows_int8(
            args[3], torch.tensor([0, 300], device=dev)))
    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    live = slice(1, 300) if dtype != "bf16" else slice(None)
    _assert_close(got[:, live], want[:, live],
                  T.KERNEL_VS_PLAIN_RTOL["maxsim_" + dtype])
    if dtype != "bf16":                       # masked rows score the mask
        assert torch.equal(got[:, [0, 300]], want[:, [0, 300]])
    if dtype == "int4":
        qi, qs, pool, aux = args
        assert torch.equal(got, T.bilinear_maxsim_scores_int8(
            qi, qs, T.unpack_int4(pool), aux))


def test_masked_bf16_candidates_never_win():
    dev = _cuda()
    q, cand, w = _operands(dev, 4, 100, 40, 5, 4, 50)
    pool = T.mask_out_candidates(T.pack_candidate_pool(cand), 90)
    s = T.bilinear_maxsim_scores(T.project_queries(q, w), pool)
    assert torch.all(s[:, 90:] < -1e29) and torch.all(s[:, :90] > -1e29)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    q, cand, w = _operands(dev, 2, 50, 40, 5, 4, 50)
    qw, pool = T.project_queries(q, w), T.pack_candidate_pool(cand)
    n0 = dict(T.LAUNCH_COUNTS)
    with pytest.raises(TypeError):
        T.bilinear_maxsim_scores(qw.float(), pool.float())
    with pytest.raises(ValueError):
        T.bilinear_maxsim_scores(qw, pool.transpose(0, 1).contiguous()
                                 .transpose(0, 1))
    with pytest.raises(ValueError):
        T.bilinear_maxsim_scores(qw, pool.cpu())
    qi, qs = T.project_queries_int8(q, w)
    p8, aux = T.pack_candidate_pool_int8(cand)
    with pytest.raises(TypeError):
        T.bilinear_maxsim_scores_int8(qi, qs.double(), p8, aux)
    q4, qs4 = T.project_queries_int4(q, w)
    p4, aux4 = T.pack_candidate_pool_int4(cand)
    with pytest.raises(TypeError):           # packed bytes must be uint8
        T.bilinear_maxsim_scores_int4(q4, qs4, p4.view(torch.int8), aux4)
    with pytest.raises(ValueError):          # the unpacked pool's width
        T.bilinear_maxsim_scores_int4(q4, qs4, T.unpack_int4(p4), aux4)
    with pytest.raises(ValueError):          # not contiguous
        T.bilinear_maxsim_scores_int4(q4, qs4, p4.transpose(0, 1)
                                      .contiguous().transpose(0, 1), aux4)
    with pytest.raises(ValueError):          # operands on two devices
        T.bilinear_maxsim_scores_int4(q4, qs4, p4.cpu(), aux4)
    with pytest.raises(ValueError):          # Dp not a multiple of 32 bytes
        T.bilinear_maxsim_scores_int4(
            torch.zeros((2, 3, 80), dtype=torch.int8, device=dev),
            qs4[:, :3].contiguous(),
            torch.zeros((5, 8, 40), dtype=torch.uint8, device=dev),
            aux4[:5])
    assert T.LAUNCH_COUNTS == n0


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_rows_past_256_bytes_match_plain(dtype):
    """Dp 288 (int8 and int4) or 144 (bf16), once refused: the K-sliced
    plan, whose last 128-byte span runs past Dp."""
    dev = _cuda()
    d = 143 if dtype == "bf16" else 288
    q, cand, w = _operands(dev, 2, 50, 40, 3, 4, d)
    kernel, plain, args = _scorer(dtype, q, cand, w)
    assert args[0].shape[2] * args[0].element_size() > 256
    geo = T.maxsim_geometry(2, 12, 50, 40, args[0].shape[2], dtype)
    assert geo.k_sliced
    got = kernel(*args)
    torch.cuda.synchronize()
    _assert_close(got, plain(*args), T.KERNEL_VS_PLAIN_RTOL["maxsim_" + dtype])


@pytest.mark.parametrize("d", [50, 300])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_r_800_matches_plain(dtype, d):
    """R = 800 query rows (W1 = 200, M = 4): resident at D = 50, K-sliced
    with the query rows streamed at D = 300; int4 bit-identical to int8 on
    the unpacked codes."""
    dev = _cuda()
    q, cand, w = _operands(dev, 3, 301, 40, 200, 4, d)
    kernel, plain, args = _scorer(dtype, q, cand, w)
    dp = args[0].shape[2]
    assert T.maxsim_geometry(3, 800, 301, 40, dp, dtype).k_sliced == (d == 300)
    got = kernel(*args)
    torch.cuda.synchronize()
    _assert_close(got, plain(*args), T.KERNEL_VS_PLAIN_RTOL["maxsim_" + dtype])
    if dtype == "int4":
        qi, qs, pool, aux = args
        assert torch.equal(got, T.bilinear_maxsim_scores_int8(
            qi, qs, T.unpack_int4(pool), aux))


def test_topk_tie_rule_on_cuda():
    dev = _cuda()
    s = torch.zeros((3, 5000), device=dev)
    s[:, 4000] = 1.0
    vals, idx = topk(s, 7)
    assert idx[:, 0].tolist() == [4000] * 3
    assert idx[:, 1:].tolist() == [[0, 1, 2, 3, 4, 5]] * 3


def _v4_engine_inputs():
    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                              sim_weight_init="xavier")
    params, state = TM.mms_qa_init(cfg, generator=torch.Generator()
                                   .manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params["embed"]["w"] = torch.randn((500, 50), generator=g) * 0.3
    state = {k: {"mean": v["mean"], "var": v["var"] + 1.0}
             for k, v in state.items()}
    cand = torch.randint(0, 500, (3000, 40), generator=g)
    return cfg, params, state, cand, g


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_engine_on_cuda_matches_engine_on_cpu(pool_dtype):
    dev = _cuda()
    cfg, params, state, cand, g = _v4_engine_inputs()
    queries = torch.randint(0, 500, (6, 40), generator=g)
    # copy query 0's best candidate to another row: the two tie for first
    # place, and the lower index must come first on the card too
    top = int(QueryEngine(params, cfg, pool_dtype=pool_dtype, device="cpu")
              .build_index(cand).query(queries[:1], k=1)[1][0, 0])
    dup = 0 if top == len(cand) - 1 else len(cand) - 1
    cand[dup] = cand[top]
    out = {}
    for where in ("cpu", "cuda"):
        eng = QueryEngine(params, cfg, pool_dtype=pool_dtype, device=where)
        eng.build_index(cand)
        vals, idx = eng.query(queries, k=10)
        rv, ri = eng.query_rerank(state, queries, k=5, shortlist=20)
        out[where] = [t.cpu() for t in (vals, idx, rv, ri)]
    (cv, ci, crv, cri), (gv, gi, grv, gri) = out["cpu"], out["cuda"]
    rtol = T.KERNEL_VS_PLAIN_RTOL["maxsim_" + pool_dtype]
    _assert_close(gv, cv, rtol)
    assert gi[0, :2].tolist() == sorted([top, dup]) == ci[0, :2].tolist()
    gaps = (cv[:, :-1] - cv[:, 1:]).abs()
    sep = gaps > 2 * rtol * cv.abs().amax(dim=1, keepdim=True)
    pinned = torch.cat([sep[:, :1], sep[:, 1:] & sep[:, :-1], sep[:, -1:]], 1)
    assert torch.equal(gi[pinned], ci[pinned])
    assert torch.allclose(grv, crv, atol=1e-5)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_chunked_tombstones_and_reload_on_cuda(pool_dtype, tmp_path):
    dev = _cuda()
    cfg, params, state, cand, g = _v4_engine_inputs()
    queries = torch.randint(0, 500, (6, 40), generator=g)
    eng = QueryEngine(params, cfg, pool_dtype=pool_dtype, device=dev)
    eng.build_index(cand[:2500], reserve=100)
    flat = eng.query(queries, k=50)
    eng.chunk_size = 700                    # 4 chunks, the last ragged
    chunked = eng.query(queries, k=50)
    assert all(torch.equal(a, b) for a, b in zip(flat, chunked))
    # tombstones: every query's top 3 and a few more never come back
    dead = set(flat[1][:, :3].flatten().tolist()) | {0, 2499}
    eng.remove_candidates(sorted(dead))
    vals, idx = eng.query(queries, k=50)
    assert not set(idx.flatten().tolist()) & dead
    _, ridx = eng.query_rerank(state, queries, k=5, shortlist=30)
    assert not set(ridx.flatten().tolist()) & dead
    # added rows are found: a copy of query 0's best live hit
    best = int(idx[0, 0])
    new = eng.add_candidates(cand[best:best + 1].to(dev))
    assert int(new[0]) == 2500
    top2 = eng.query(queries[:1], k=2)[1][0].tolist()
    assert top2 == [best, 2500]
    eng.save_index(str(tmp_path / "index.npz"))
    other = QueryEngine(params, cfg, pool_dtype=pool_dtype, device=dev)
    other.load_index(str(tmp_path / "index.npz"))
    assert all(torch.equal(a, b) for a, b in
               zip(other.query(queries, k=50), eng.query(queries, k=50)))
    mapping = eng.compact()
    assert int(mapping[best]) >= 0 and all(int(mapping[d]) == -1
                                           for d in dead)
    after = eng.query(queries, k=10)[1].cpu()
    before = other.query(queries, k=10)[1].cpu()
    assert torch.equal(mapping[before], after)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_ivf_probe_all_equals_brute_force_on_cuda(pool_dtype):
    dev = _cuda()
    cfg, params, _, cand, g = _v4_engine_inputs()
    queries = torch.randint(0, 500, (3, 40), generator=g)
    eng = QueryEngine(params, cfg, pool_dtype=pool_dtype, device=dev)
    eng.build_index(cand)
    eng.remove_candidates([5, 6])
    n0 = dict(T.LAUNCH_COUNTS)
    ivf = eng.build_ivf(n_clusters=16, coarse_tokens=4)
    bv, bi = eng.query(queries, k=10)
    pv, pi = eng.query_ivf(queries, k=10, nprobe=16)
    assert torch.equal(pv, bv) and torch.equal(pi, bi)
    cv, ci = ivf.query_coarse(queries, k=10, shortlist=len(cand))
    assert torch.equal(cv, bv) and torch.equal(ci, bi)
    assert T.LAUNCH_COUNTS["maxsim_" + pool_dtype] > n0["maxsim_" + pool_dtype]
    assert T.LAUNCH_COUNTS["maxsim_bf16"] > n0["maxsim_bf16"]  # mini pool


# ------------------------------------------------------------ pair maps
# (N, W1, W2, D, M): V4 at batch 50 and 1024, a ragged batch of 7 and of 1,
# V4_WIDE's D = 300, and the kernels' edges: D of 1, 31, 33, 64 and 301
# (1, 2 or 4 floats per copy; one or several column tiles and slabs), W1
# and W2 of 1, 7, 40 and 64, unequal (one or several row parts, partial
# register tiles), M not a multiple of 4 (a partial measure group)
PAIR_SHAPES = [(50, 40, 40, 50, 4), (7, 40, 40, 50, 4), (1, 40, 40, 50, 4),
               (50, 40, 40, 300, 4), (7, 40, 40, 300, 4),
               (3, 64, 5, 33, 1), (2, 9, 64, 70, 3),
               (1024, 40, 40, 50, 4), (1024, 64, 7, 50, 4),
               (1, 1, 7, 1, 4), (7, 7, 1, 31, 4), (50, 64, 40, 33, 4),
               (7, 40, 64, 64, 4), (50, 7, 40, 301, 4), (50, 40, 1, 300, 2),
               (7, 40, 7, 64, 5), (1, 64, 64, 301, 4),
               # past 64 rows: W1 in forward parts and W1 tiles of dW, W2
               # tiles of the forward (W2 > 200), chunks of x in dQ / dA
               # (K > 128), output row tiles; V4_WIDE at batch 1024
               (7, 65, 40, 50, 4), (7, 40, 100, 300, 4),
               (3, 100, 100, 300, 4), (2, 200, 64, 50, 4),
               (2, 40, 201, 33, 4), (2, 130, 9, 300, 3),
               (1024, 40, 40, 300, 4), (128, 65, 100, 300, 4),
               (64, 200, 200, 300, 4),
               # caption-to-image training (configs[4]): 12 caption tokens
               # against 25 image patches, M = 2 (a partial measure group)
               (50, 12, 25, 50, 2), (1024, 12, 25, 50, 2), (7, 12, 25, 50, 2)]
# dW must come out bit-identical across runs where its batch is split in
# chunks: V4 at batch 50 and 1024, V4_WIDE, and W1 tiled
DW_SHAPES = [(50, 40, 40, 50, 4), (1024, 40, 40, 50, 4), (50, 40, 40, 300, 4),
             (1024, 40, 40, 300, 4), (1024, 65, 100, 300, 4),
             (7, 200, 100, 300, 4)]


def _pair_operands(dev, n, w1, w2, d, m, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + n * 7 + d)
    q = torch.randn((n, w1, d), generator=g, device=dev) * 0.3
    a = torch.randn((n, w2, d), generator=g, device=dev) * 0.3
    w = torch.randn((m, d, d), generator=g, device=dev) * 0.05
    gr = torch.randn((n, w1, w2, m), generator=g, device=dev)
    return q, a, w, gr


def _assert_close_to_max(got, want, rtol):
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= rtol, rel


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_pair_map_kernels_match_plain(shape):
    dev = _cuda()
    q, a, w, g = _pair_operands(dev, *shape)
    n0 = dict(T.LAUNCH_COUNTS)
    tq, ta, tw = (x.clone().requires_grad_(True) for x in (q, a, w))
    out = T.bilinear_pair_maps(tq, ta, tw)
    out.backward(g)
    torch.cuda.synchronize()
    for name in ("pair_maps_fwd", "pair_maps_bwd_qa", "pair_maps_bwd_w"):
        assert T.LAUNCH_COUNTS[name] == n0[name] + 1, name
    _assert_close_to_max(out, T.bilinear_pair_maps_plain(q, a, w),
                         T.KERNEL_VS_PLAIN_RTOL["pair_maps_fwd"])
    dq, da, dw = T.bilinear_pair_maps_grads_plain(q, a, w, g)
    rtol = T.KERNEL_VS_PLAIN_RTOL
    _assert_close_to_max(tq.grad, dq, rtol["pair_maps_bwd_qa"])
    _assert_close_to_max(ta.grad, da, rtol["pair_maps_bwd_qa"])
    _assert_close_to_max(tw.grad, dw, rtol["pair_maps_bwd_w"])


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_pair_map_dw_is_deterministic(shape):
    dev = _cuda()
    q, a, w, g = _pair_operands(dev, *shape)
    runs = []
    for _ in range(2):
        tw = w.clone().requires_grad_(True)
        T.bilinear_pair_maps(q, a, tw).backward(g)
        runs.append(tw.grad)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


def test_pair_map_backward_takes_a_strided_gradient():
    dev = _cuda()
    q, a, w, g = _pair_operands(dev, 4, 40, 40, 50, 4)
    gt = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not gt.is_contiguous()
    tw = w.clone().requires_grad_(True)
    T.bilinear_pair_maps(q, a, tw).backward(gt)
    _assert_close_to_max(tw.grad, T.bilinear_pair_maps_grads_plain(
        q, a, w, g)[2], T.KERNEL_VS_PLAIN_RTOL["pair_maps_bwd_w"])


def test_pair_map_wrapper_raises_on_what_the_kernels_do_not_take():
    dev = _cuda()
    q, a, w, _ = _pair_operands(dev, 2, 65, 40, 8, 2)
    # W1 = 65, once refused, now runs
    _assert_close_to_max(T.bilinear_pair_maps(q, a, w),
                         T.bilinear_pair_maps_plain(q, a, w),
                         T.KERNEL_VS_PLAIN_RTOL["pair_maps_fwd"])
    n0 = dict(T.LAUNCH_COUNTS)
    q, a, w, _ = _pair_operands(dev, 2, 40, 40, 8, 2)
    with pytest.raises(TypeError):
        T.bilinear_pair_maps(q.double(), a.double(), w.double())
    with pytest.raises(ValueError):
        T.bilinear_pair_maps(q.transpose(1, 2).contiguous().transpose(1, 2),
                             a, w)
    with pytest.raises(ValueError):
        T.bilinear_pair_maps(q, a.cpu(), w)
    assert T.LAUNCH_COUNTS == n0


def test_pair_map_backward_launches_only_what_is_needed():
    dev = _cuda()
    q, a, w, g = _pair_operands(dev, 3, 40, 40, 50, 4)
    n0 = dict(T.LAUNCH_COUNTS)
    T.bilinear_pair_maps(q, a, w.clone().requires_grad_(True)).backward(g)
    assert T.LAUNCH_COUNTS["pair_maps_bwd_w"] == n0["pair_maps_bwd_w"] + 1
    assert T.LAUNCH_COUNTS["pair_maps_bwd_qa"] == n0["pair_maps_bwd_qa"]
    with torch.no_grad():
        T.bilinear_pair_maps(q, a, w)
    assert T.LAUNCH_COUNTS["pair_maps_fwd"] == n0["pair_maps_fwd"] + 2


def test_train_step_on_cuda_matches_cpu():
    """One V4 train step (dropout off, xavier W, batch 50) on the card and
    on the CPU from the same params and batch.  Loss within 1e-5 relative;
    every param within rtol 1e-4 + atol 1e-5, except the conv biases:
    each feeds a train-mode BN, so its true gradient is 0 and both devices
    move it by AdaDelta's normalized step in a direction set by rounding
    noise, at most lr_mult(2) * sqrt(delta / (1 - momentum))."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                              sim_weight_init="xavier", sim_dropout=0.0,
                              fc1_dropout=0.0)
    tcfg = TrainerConfig(solver=SolverConfig(), batch_size=50)
    g = torch.Generator().manual_seed(4)
    batch = {"question": torch.randint(0, 500, (50, 40), generator=g),
             "answer": torch.randint(0, 500, (50, 40), generator=g),
             "overlap_feat": torch.rand((50, 2), generator=g),
             "label": (torch.rand((50,), generator=g) < 0.3).int()}
    out = {}
    for where in ("cpu", "cuda"):
        tr = Trainer(cfg, tcfg, device=where)
        p, s, o = tr.init()
        b = {k: v.to(where) for k, v in batch.items()}
        out[where] = tree_map(lambda t: t.cpu(), dict(zip(
            ("p", "s", "o", "loss"), tr._train_step(p, s, o, b, 0))))
    cpu, card = out["cpu"], out["cuda"]
    assert abs(float(card["loss"]) / float(cpu["loss"]) - 1) <= 1e-5
    band = 2 * (5e-7 / 0.05) ** 0.5
    for name in cpu["p"]:
        for k, want in cpu["p"][name].items():
            got = card["p"][name][k]
            if name.startswith("conv") and k == "b":
                assert float((got - want).abs().max()) <= 2 * band
            else:
                assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                    (name, k, float((got - want).abs().max()))


def test_checkpoint_of_cuda_tensors_round_trips_onto_the_card(tmp_path):
    """Tensors on the card are saved through the host and restored onto
    the template's device, bit for bit."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)
    from mms_answer_selection_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from mms_answer_selection_tpu_torch.utils.tree import (
        tree_leaves, tree_map)

    tr = Trainer(dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                                     sim_weight_init="xavier"),
                 TrainerConfig(solver=SolverConfig()), device=dev)
    p, s, o = tr.init()
    bundle = {"params": p, "state": s, "opt_state": o}
    path = save_checkpoint(str(tmp_path), 3, bundle, meta={"epoch": 1})
    got, meta = load_checkpoint(path,
                                template=tree_map(torch.zeros_like, bundle))
    assert meta == {"step": 3, "epoch": 1}
    for a, b in zip(tree_leaves(got), tree_leaves(bundle)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_next_device_equals_a_direct_gather_under_refill(tmp_path):
    """40 batches of about 20 MB through next_device at ring depth 2, each
    kept on the card while the worker refills its slot at once, equal
    the rows a direct PackedStore.gather reads (each row carries its own
    index, so the batch names its rows)."""
    dev = _cuda()
    import numpy as np

    from mms_answer_selection_tpu_torch.native import (
        NativePrefetcher, PackedStore, write_mmsp)

    n, cols, bs = 6000, 1280, 4096
    rng = np.random.default_rng(0)
    path = str(tmp_path / "big.mmsp")
    write_mmsp(path, {"row": np.arange(n, dtype=np.int32),
                      "x": rng.random((n, cols), dtype=np.float32),
                      "ids": rng.integers(0, 2**31 - 1, (n, 7)).astype(
                          np.int32)})
    store = PackedStore(path)
    ring = NativePrefetcher(store, ["row", "x", "ids"], bs, seed=3, depth=2)
    kept = [ring.next_device(dev) for _ in range(40)]
    torch.cuda.synchronize()
    for batch in kept:
        assert batch["x"].device.type == "cuda"
        rows = batch["row"][:, 0].cpu().numpy()
        for name in ("x", "ids"):
            want = torch.from_numpy(store.gather(name, rows))
            assert torch.equal(batch[name].cpu(), want), name
    seen = np.concatenate([b["row"][:, 0].cpu().numpy() for b in kept])
    assert len(np.unique(seen[:n])) == n      # the first pass is a shuffle


def test_fit_stream_on_cuda_matches_cpu(tmp_path):
    """Three steps of fit_stream from one packed file (V4, batch 50,
    dropout off, xavier W) on the card and on the CPU: the same steps and
    evals, losses within 1e-5 relative, params within the one-step check's
    rtol 1e-4 + atol 1e-5.  The conv biases are left out: each feeds a
    train-mode BN, so its true gradient is 0 and AdaDelta moves it on
    either device by a normalized step of rounding noise, inside a band
    that any gradient would keep to.

    Dev MAP is a step function of the scores, so it is held group by
    group: each device's in-graph MAP equals the numpy MAP of its own dev
    probabilities (1e-6), and a group's AP on the card equals the CPU's
    wherever every positive-negative gap of the CPU's scores exceeds twice
    the largest card-vs-CPU probability difference (no near-tie that
    rounding could reorder); at least 9 of the 12 groups must qualify.
    The embedding starts from vectors of GloVe's scale, as the recipe's
    does: from the ±0.08 fill alone the sim map's spread is so small that
    eval-mode BN magnifies the conv biases' noise steps (an H100 run read
    P(correct) 1.1e-2 apart after one step)."""
    dev = _cuda()
    import numpy as np

    from mms_answer_selection_tpu_torch.metrics import mean_average_precision
    from mms_answer_selection_tpu_torch.native import (
        NativePrefetcher, PackedStore, write_mmsp)
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)

    class Recording(Trainer):
        """Keeps each eval's P(correct) on the host."""
        probs: list

        def _eval_step(self, params, state, batch):
            res = super()._eval_step(params, state, batch)
            self.probs.append(res["prob"][:, 1].cpu().double().numpy())
            return res

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                              sim_weight_init="xavier", sim_dropout=0.0,
                              fc1_dropout=0.0)
    tcfg = TrainerConfig(solver=SolverConfig(), batch_size=50,
                         test_interval=2, train_loss_record_interval=1)
    rng = np.random.default_rng(5)

    def rows(n):
        return {"question": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "answer": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "overlap_feat": rng.random((n, 2)).astype(np.float32),
                "label": (rng.random(n) < 0.3).astype(np.int32)}

    path = str(tmp_path / "train.mmsp")
    write_mmsp(path, rows(300))
    groups = np.repeat(np.arange(12), 10)
    dev_split = rows(120) | {"group": groups}
    labels = dev_split["label"]
    glove = (0.5 * rng.standard_normal((500, 50))).astype(np.float32)
    out, probs = {}, {}
    for where in ("cpu", dev):
        ring = NativePrefetcher(PackedStore(path), ["question", "answer",
                                                    "label", "overlap_feat"],
                                50, seed=1)
        tr = Recording(cfg, tcfg, device=where)
        tr.probs = []
        out[str(where)] = tr.fit_stream(ring, dev_split, steps=3,
                                        pretrained=glove)
        probs[str(where)] = tr.probs
    cpu, card = out["cpu"], out[str(dev)]
    assert card["steps"] == cpu["steps"] == [0, 2]
    np.testing.assert_allclose(card["train_loss"], cpu["train_loss"],
                               rtol=1e-5)
    for name, sub in cpu["params"].items():
        for k, want in sub.items():
            if name.startswith("conv") and k == "b":
                continue
            got = card["params"][name][k].cpu()
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                (name, k, float((got - want).abs().max()))

    for e, (p_cpu, p_card) in enumerate(zip(probs["cpu"], probs[str(dev)],
                                            strict=True)):
        for where, p in (("cpu", p_cpu), (str(dev), p_card)):
            assert abs(out[where]["dev_map"][e] - mean_average_precision(
                p, labels, groups)) <= 1e-6, (where, e)
        diff = float(np.abs(p_card - p_cpu).max())
        held = 0
        for g in range(12):
            at = groups == g
            pos, neg = p_cpu[at & (labels == 1)], p_cpu[at & (labels == 0)]
            if np.abs(pos[:, None] - neg[None, :]).min() <= 2 * diff:
                continue
            held += 1
            assert mean_average_precision(p_card[at], labels[at],
                                          groups[at]) \
                == mean_average_precision(p_cpu[at], labels[at],
                                          groups[at]), (e, g, diff)
        assert held >= 9, (e, held, diff)


def _caption_step_inputs():
    from mms_answer_selection_tpu_torch.models import CaptionImageConfig

    cfg = CaptionImageConfig()
    g = torch.Generator().manual_seed(8)
    first = torch.randint(0, 8, (50,), generator=g)
    pos = 0.1 * torch.randn((50, 16, 16, 3), generator=g)
    pos[torch.arange(50), first, :, 0] += 2.0
    batch = {"caption": first[:, None].repeat(1, 12),
             "image_pos": pos,
             "image_neg": torch.randn((50, 16, 16, 3), generator=g)}
    return cfg, batch


def test_caption_train_step_on_cuda_matches_cpu():
    """One caption-to-image AdaDelta step at CaptionImageConfig()'s
    defaults (batch 50, pair maps at W1 = 12, W2 = 25, M = 2) on the card
    and on the CPU from the same weights: the three pair-map kernels run
    twice each (one score call for the positive image, one for the
    negative); loss within 1e-5 relative, every param within rtol 1e-4 +
    atol 1e-5, the conv biases (rounding noise under train-mode BN) within
    AdaDelta's band."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.models import (
        caption_image_apply, caption_image_init)
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    torch.backends.cudnn.allow_tf32 = False
    cfg, batch = _caption_step_inputs()
    tcfg = TrainerConfig(solver=SolverConfig(weight_decay=0.0),
                         batch_size=50)
    out = {}
    for where in ("cpu", "cuda"):
        tr = Trainer(cfg, tcfg, device=where, apply_fn=caption_image_apply,
                     init_fn=caption_image_init)
        p, s, o = tr.init()
        n0 = dict(T.LAUNCH_COUNTS)
        res = tr._train_step(p, s, o, {k: v.to(where) for k, v in
                                       batch.items()}, 0)
        if where == "cuda":
            torch.cuda.synchronize()
            for name in ("pair_maps_fwd", "pair_maps_bwd_qa",
                         "pair_maps_bwd_w"):
                assert T.LAUNCH_COUNTS[name] == n0[name] + 2, name
        out[where] = tree_map(lambda t: t.cpu(), dict(zip(
            ("p", "s", "o", "loss"), res)))
    cpu, card = out["cpu"], out["cuda"]
    assert abs(float(card["loss"]) / float(cpu["loss"]) - 1) <= 1e-5
    band = 2 * 2 * (5e-7 / 0.05) ** 0.5
    for name in cpu["p"]:
        for k, want in cpu["p"][name].items():
            got = card["p"][name][k]
            if name.startswith("conv") and k == "b":
                assert float((got - want).abs().max()) <= band
            else:
                assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                    (name, k, float((got - want).abs().max()))


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_image_pool_on_cuda_matches_cpu(pool_dtype):
    """An image pool of CaptionImageConfig() patch tokens (25 a row, W2P =
    32) served from the host by build_index_from_tokens, queried with
    caption tokens (R = 24) in chunks: scores within the kernel's
    tolerance of the CPU engine's, indices equal wherever no neighbour is
    within twice it, chunked = unchunked bit for bit on the card."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.models import (
        caption_image_init, encode_image)
    from mms_answer_selection_tpu_torch.ops.embed import embed_lookup

    cfg, _ = _caption_step_inputs()
    params, state = caption_image_init(cfg, generator=torch.Generator()
                                       .manual_seed(3))
    state = {k: {"mean": v["mean"], "var": v["var"] + 1.0}
             for k, v in state.items()}
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        tokens, _ = encode_image(params, state, torch.randn(
            (3000, 16, 16, 3), generator=g), cfg, train=False)
        q = embed_lookup(params["embed"], torch.randint(0, 100, (9, 12),
                                                        generator=g))
    qa = TM.MMSQAConfig(vocab_size=100, sim_measures=2)
    out = {}
    for where in ("cpu", "cuda"):
        eng = QueryEngine(params, qa, pool_dtype=pool_dtype, chunk_size=1024,
                          device=where).build_index_from_tokens(tokens)
        out[where] = [t.cpu() for t in eng.query(q, k=10)]
        if where == "cuda":
            eng.chunk_size = eng.pool_size
            flat = [t.cpu() for t in eng.query(q, k=10)]
            assert all(torch.equal(a, b) for a, b in zip(flat, out[where]))
    (cv, ci), (gv, gi) = out["cpu"], out["cuda"]
    rtol = T.KERNEL_VS_PLAIN_RTOL["maxsim_" + pool_dtype]
    _assert_close(gv, cv, rtol)
    gaps = (cv[:, :-1] - cv[:, 1:]).abs()
    sep = gaps > 2 * rtol * cv.abs().amax(dim=1, keepdim=True)
    pinned = torch.cat([sep[:, :1], sep[:, 1:] & sep[:, :-1], sep[:, -1:]], 1)
    assert torch.equal(gi[pinned], ci[pinned])


def _generic_v4_net(vocab=500, phase="train"):
    from mms_answer_selection_tpu_torch.utils.prototxt import \
        net_prototxt_from_config

    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=vocab,
                              sim_dropout=0.0, fc1_dropout=0.0)
    return net_prototxt_from_config(cfg, phase=phase)


def _generic_v4_batch(n=50, vocab=500):
    g = torch.Generator().manual_seed(6)
    return {"question": torch.randint(0, vocab, (n, 40), generator=g),
            "answer": torch.randint(0, vocab, (n, 40), generator=g),
            "overlap_feat": torch.rand((n, 2), generator=g),
            "label": (torch.rand((n,), generator=g) < 0.3).int(),
            "group": torch.arange(n) // 10}


def test_graph_net_v4_on_cuda_matches_cpu():
    """The V4 recipe's train net through GraphNet at V4's widths, batch
    50, from one set of params (a xavier W) on the card and on the CPU:
    the loss within 1e-5 relative, fc2 within 1e-5 of its max |value|,
    every gradient within 1e-4 of its leaf's max |value| but the conv
    biases (rounding noise under train-mode BN: each within 5% of its
    weight's largest gradient); the eval net's MAP / MRR / AUC to 1e-6."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
    from mms_answer_selection_tpu_torch.utils.tree import (tree_leaves,
                                                           tree_map)

    torch.backends.cudnn.allow_tf32 = False
    batch = _generic_v4_batch()
    net = GraphNet(_generic_v4_net(), phase="train")
    params, state = net.init(torch.Generator().manual_seed(1), batch,
                             device="cpu")
    params["sim_cross"]["w"] = torch.empty_like(
        params["sim_cross"]["w"]).uniform_(
            -0.035, 0.035, generator=torch.Generator().manual_seed(2))
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                     params)
        s = tree_map(lambda t: t.to(where), state)
        loss, (blobs, _) = net.loss(p, s, {k: v.to(where) for k, v in
                                           batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        it = iter(grads)
        out[str(where)] = (float(loss), blobs["fc2"].detach().cpu(),
                           tree_map(lambda _: next(it).cpu(), p))
    (cl, cf, cg), (gl, gf, gg) = out["cpu"], out[str(dev)]
    assert abs(gl / cl - 1) <= 1e-5
    assert float((gf - cf).abs().max()) <= 1e-5 * float(cf.abs().max())
    for name, sub in cg.items():
        for k, want in sub.items():
            got = gg[name][k]
            if name.startswith("conv") and k == "b":
                scale = float(cg[name]["w"].abs().max())
                assert float(got.abs().max()) <= 0.05 * scale
            else:
                err = float((got - want).abs().max())
                assert err <= 1e-4 * float(want.abs().max()), (name, k, err)
    ev = GraphNet(_generic_v4_net(phase="eval"), phase="test")
    state = {k: {"mean": v["mean"] + 0.01, "var": v["var"] + 1e-3}
             for k, v in state.items()}
    res = {}
    with torch.no_grad():
        for where in ("cpu", dev):
            b, _ = ev.apply(tree_map(lambda t: t.to(where), params),
                            tree_map(lambda t: t.to(where), state),
                            {k: v.to(where) for k, v in batch.items()})
            res[str(where)] = [float(b[m]) for m in ("map", "mrr", "auc")]
    assert max(abs(a - c) for a, c in zip(res["cpu"], res[str(dev)])) \
        <= 1e-6


def test_generic_step_launches_the_pair_map_kernels(tmp_path):
    """One GraphSolver step on the V4 recipe's net launches the forward
    once and each backward kernel once (the first step captures its graph
    after a warm-up step run eagerly, so it launches each twice); a test
    pass launches only the forward."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver

    (tmp_path / "net.prototxt").write_text(_generic_v4_net())
    (tmp_path / "solver.prototxt").write_text(
        'net: "net.prototxt"\ntype: "AdaDelta"\nbase_lr: 1.0\n'
        'momentum: 0.95\ndelta: 5e-7\nmax_iter: 2\ntest_interval: 0\n'
        'test_iter: 1\nsnapshot_after_train: false\n')
    batch = {k: v.numpy() for k, v in _generic_v4_batch().items()
             if k != "group"}
    gs = GraphSolver(str(tmp_path / "solver.prototxt"),
                     feeds={"data": {**batch, "batch_size": 50}},
                     device=dev)
    for extra in (1, 0):                 # the capture's warm-up, then none
        n0 = dict(T.LAUNCH_COUNTS)
        gs.step(1)
        torch.cuda.synchronize()
        for name in ("pair_maps_fwd", "pair_maps_bwd_qa",
                     "pair_maps_bwd_w"):
            assert T.LAUNCH_COUNTS[name] == n0[name] + 1 + extra, name
    assert gs.params["sim_cross"]["w"].is_cuda


def _pycaffe_files(tmp_path):
    """The V4 recipe's train and eval nets (no dropout) and an AdaDelta
    solver whose test net's data layer is named "dev"."""
    (tmp_path / "train.prototxt").write_text(_generic_v4_net())
    (tmp_path / "test.prototxt").write_text(_generic_v4_net(
        phase="eval").replace('name: "data"', 'name: "dev"', 1))
    (tmp_path / "solver.prototxt").write_text(
        'train_net: "train.prototxt"\ntest_net: "test.prototxt"\n'
        'type: "AdaDelta"\nbase_lr: 1.0\nmomentum: 0.95\ndelta: 5e-7\n'
        'max_iter: 2\ntest_interval: 0\ntest_iter: 1\n'
        'snapshot_after_train: false\n')
    batch = {k: v.numpy() for k, v in _generic_v4_batch().items()}
    feeds = {"data": {k: v for k, v in batch.items() if k != "group"},
             "dev": {**batch, "shuffle": False}}
    feeds["data"]["batch_size"] = feeds["dev"]["batch_size"] = 50
    return str(tmp_path / "solver.prototxt"), feeds, batch


@pytest.fixture
def gpu_mode():
    from mms_answer_selection_tpu_torch import caffe_compat as caffe

    caffe.set_mode_gpu()
    yield caffe
    caffe.set_mode_gpu()


def test_pycaffe_step_launches_the_pair_map_kernels(tmp_path, gpu_mode):
    """One ``solver.step(1)`` through ``caffe.get_solver`` under
    ``set_mode_gpu()`` launches the forward once and each backward kernel
    once; a forward of ``solver.test_nets[0]`` launches only the forward
    (the first of each captures its graph after a warm-up call run
    eagerly, so it launches its kernels twice)."""
    dev = _cuda()
    caffe = gpu_mode
    path, feeds, _ = _pycaffe_files(tmp_path)
    solver = caffe.get_solver(path, feeds=feeds)
    assert solver._gs.device.type == dev.type
    for extra in (1, 0):
        n0 = dict(T.LAUNCH_COUNTS)
        solver.step(1)
        torch.cuda.synchronize()
        for name in ("pair_maps_fwd", "pair_maps_bwd_qa",
                     "pair_maps_bwd_w"):
            assert T.LAUNCH_COUNTS[name] == n0[name] + 1 + extra, name
    for extra in (1, 0):
        n1 = dict(T.LAUNCH_COUNTS)
        out = solver.test_nets[0].forward()
        torch.cuda.synchronize()
        assert T.LAUNCH_COUNTS["pair_maps_fwd"] == \
            n1["pair_maps_fwd"] + 1 + extra
        assert T.LAUNCH_COUNTS["pair_maps_bwd_w"] == n1["pair_maps_bwd_w"]
        assert T.LAUNCH_COUNTS["pair_maps_bwd_qa"] == \
            n1["pair_maps_bwd_qa"]
    assert 0 <= float(out["map"]) <= 1
    assert float(solver.net.blobs["loss"].data) > 0


def test_caffe_net_forward_on_cuda_matches_cpu(tmp_path, gpu_mode):
    """``caffe.Net`` on the V4 eval net with one ``.caffemodel`` (a xavier
    W, positive running variances) on the card and on the CPU: prob
    within 1e-5 of its max, loss within 1e-5 relative, MAP / MRR / AUC to
    1e-6; the card's backward gives the CPU's input diff within 1e-4 of
    its max."""
    dev = _cuda()
    caffe = gpu_mode
    _, _, batch = _pycaffe_files(tmp_path)
    text = str(tmp_path / "test.prototxt")
    cpu = caffe.Net(text, caffe.TEST, device="cpu")
    cpu.forward(**batch)
    cpu.params = {**cpu.params, "sim_cross": {
        **cpu.params["sim_cross"], "w": torch.empty_like(
            cpu.params["sim_cross"]["w"]).uniform_(
                -0.035, 0.035, generator=torch.Generator().manual_seed(2))}}
    cpu.state = {k: {"mean": v["mean"] + 0.01, "var": v["var"] + 1.0}
                 for k, v in cpu.state.items()}
    cpu.save(str(tmp_path / "w.caffemodel"))
    card = caffe.Net(text, caffe.TEST, weights=str(tmp_path / "w.caffemodel"))
    assert card.device.type == dev.type
    got = {k: float(v) for k, v in card.forward(**batch).items()}
    want = {k: float(v) for k, v in cpu.forward(**batch).items()}
    prob_c, prob_g = cpu.blobs["prob"].data, card.blobs["prob"].data
    assert abs(prob_g - prob_c).max() <= 1e-5 * abs(prob_c).max()
    assert abs(got["loss"] / want["loss"] - 1) <= 1e-5
    for k in ("map", "mrr", "auc"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    dc = cpu.backward(loss=1.0)["overlap_feat"]
    dg = card.backward(loss=1.0)["overlap_feat"]
    assert abs(dg - dc).max() <= 1e-4 * abs(dc).max()


def test_set_mode_routes_nets_and_solvers(tmp_path, gpu_mode):
    """``set_mode_gpu`` (the default) and ``set_device`` put ``Net``, the
    solvers and ``Classifier`` on the card, ``set_mode_cpu`` on the CPU;
    an explicit ``device=`` wins over the mode."""
    _cuda()
    caffe = gpu_mode
    path, feeds, batch = _pycaffe_files(tmp_path)
    text = str(tmp_path / "test.prototxt")
    assert caffe.Net(text, caffe.TEST).device.type == "cuda"
    assert caffe.get_solver(path, feeds=feeds)._gs.device.type == "cuda"
    caffe.set_device(0)
    net = caffe.Net(text, caffe.TEST)
    assert net.device == torch.device("cuda:0")
    net.forward(**batch)
    assert net.params["sim_cross"]["w"].is_cuda
    caffe.set_mode_cpu()
    assert caffe.Net(text, caffe.TEST).device.type == "cpu"
    assert caffe.SGDSolver(path, feeds=feeds)._gs.device.type == "cpu"
    assert caffe.Net(text, caffe.TEST, device="cuda").device.type == "cuda"
    caffe.set_mode_gpu()
    assert caffe.AdaDeltaSolver(path, feeds=feeds,
                                device="cpu")._gs.device.type == "cpu"


# --------------------------------------------- the operator, export, meshes
def test_pair_map_operator_launches_the_kernel_and_equals_plain():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((50, 40, 50), generator=g, device=dev)
    a = torch.randn((50, 40, 50), generator=g, device=dev)
    w = torch.randn((4, 50, 50), generator=g, device=dev) * 0.1
    before = T.LAUNCH_COUNTS["pair_maps_fwd"]
    got = torch.ops.mms_torch.pair_maps_fwd(q, a, w)
    assert T.LAUNCH_COUNTS["pair_maps_fwd"] == before + 1
    want = T.bilinear_pair_maps_plain(q, a, w)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= \
        T.KERNEL_VS_PLAIN_RTOL["pair_maps_fwd"] * scale
    # the eval forward (no gradient to take) goes through the operator
    with torch.no_grad():
        T.bilinear_pair_maps(q, a, w)
    assert T.LAUNCH_COUNTS["pair_maps_fwd"] == before + 2


def test_loaded_scorer_on_cuda_equals_the_live_model(tmp_path):
    from mms_answer_selection_tpu_torch import deploy

    dev = _cuda()
    cfg = dataclasses.replace(TM.V4, vocab_size=500)
    params, state = TM.mms_qa_init(cfg, generator=torch.Generator()
                                   .manual_seed(0), device=dev)
    params["sim"]["w"].normal_(0, 0.05)
    state = {k: {"mean": torch.rand(v["mean"].shape, device=dev) * 0.1,
                 "var": torch.rand(v["var"].shape, device=dev) + 0.5}
             for k, v in state.items()}
    path = str(tmp_path / "s.mmst")
    deploy.save_scorer(path, params, state, cfg)
    scorer = deploy.load_scorer(path)
    g = torch.Generator(device=dev).manual_seed(1)
    for n in (1, 7, 64):
        batch = {"question": torch.randint(0, 500, (n, 40), generator=g,
                                           device=dev),
                 "answer": torch.randint(0, 500, (n, 40), generator=g,
                                         device=dev),
                 "overlap_feat": torch.rand((n, 2), generator=g, device=dev)}
        before = T.LAUNCH_COUNTS["pair_maps_fwd"]
        logits, prob = scorer(batch["question"], batch["answer"],
                              batch["overlap_feat"])
        assert T.LAUNCH_COUNTS["pair_maps_fwd"] == before + 1
        with torch.no_grad():
            want, _ = TM.mms_qa_apply(params, state, batch, cfg, train=False)
        want = want["logits"].cpu().numpy()
        assert abs(logits - want).max() <= 1e-5 * abs(want).max()


def _dp_case():
    """The ranks' Trainer(mesh=) run: a tiny model, three global batches
    of 8, and where the ranks import their function from."""
    import os

    from mms_answer_selection_tpu_torch.ops import _build
    from mms_answer_selection_tpu_torch.training import (SolverConfig,
                                                         TrainerConfig)

    _build.load_library()          # the ranks load the built library
    cfg = TM.MMSQAConfig(
        vocab_size=200, embed_dim=8, question_len=12, answer_len=12,
        sim_measures=2, sim_weight_init="xavier",
        blocks=(TM.ConvBlock(3, 3, 4, "ave", 2, 2),
                TM.ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
    g = torch.Generator().manual_seed(4)
    batches = [{"question": torch.randint(0, 200, (8, 12), generator=g),
                "answer": torch.randint(0, 200, (8, 12), generator=g),
                "overlap_feat": torch.rand((8, 2), generator=g),
                "label": torch.randint(0, 2, (8,), generator=g)}
               for _ in range(3)]
    kw = dict(model_cfg=cfg, trainer_cfg=TrainerConfig(
        solver=SolverConfig(), batch_size=8), batches=batches,
        device="cuda")
    return kw, [os.path.dirname(os.path.abspath(__file__))]


def _losses_close(rank, one):
    for a, b in zip(rank["losses"], one["losses"]):
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-4


def test_gloo_dp2_on_the_card_equals_dp1():
    from mms_answer_selection_tpu_torch.parallel.launch import spawn

    _cuda()
    kw, here = _dp_case()
    one = spawn("test_torch_parallel_ranks:trainer_steps", 1, kwargs=kw,
                backend="nccl", pythonpath=here, timeout=180)[0]
    for rank in spawn("test_torch_parallel_ranks:trainer_steps", 2,
                      kwargs=kw, backend="gloo", pythonpath=here,
                      timeout=180, share_device=True):
        _losses_close(rank, one)


def test_nccl_ranks_drive_their_own_cards():
    """Two ranks on a host with two cards or more: ``launch.spawn`` and
    torchrun (through ``multihost.initialize``) bind rank r to card r,
    NCCL (which refuses two ranks on one card) all-reduces across them,
    and dp = 2 over NCCL equals one rank."""
    import json
    import os
    import subprocess
    import sys

    from mms_answer_selection_tpu_torch.parallel.launch import spawn

    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    kw, here = _dp_case()
    ranks = spawn("test_torch_parallel_ranks:card_check", 2,
                  backend="nccl", pythonpath=here, timeout=180)
    assert [r["card"] for r in ranks] == [0, 1]
    assert [r["sum"] for r in ranks] == [2.0, 2.0]
    root = os.path.dirname(here[0])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         os.path.join(here[0], "test_torch_parallel_ranks.py")],
        env={**os.environ, "PYTHONPATH": root}, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    runs = sorted(json.loads(line)["card"] for line in
                  out.stdout.splitlines() if line.startswith("{"))
    assert runs == [0, 1], out.stdout
    one = spawn("test_torch_parallel_ranks:trainer_steps", 1, kwargs=kw,
                backend="nccl", pythonpath=here, timeout=180)[0]
    for rank in spawn("test_torch_parallel_ranks:trainer_steps", 2,
                      kwargs=kw, backend="nccl", pythonpath=here,
                      timeout=180):
        _losses_close(rank, one)


def _launches(fn):
    for name in T.LAUNCH_COUNTS:
        T.LAUNCH_COUNTS[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(T.LAUNCH_COUNTS)


def test_trec_qa_mms_twin_launches_the_pair_maps_and_maxsim(tmp_path):
    """The examples' twin on the card: training through the three pair-map
    kernels, retrieval through the bf16 MaxSim kernel.  The card's scores
    part from the CPU's by rounding, so the check is the launches and a
    valid MAP."""
    _cuda()
    from mms_answer_selection_tpu_torch.examples import trec_qa_mms

    out, got = _launches(lambda: trec_qa_mms.main(["--out", str(tmp_path)]))
    assert 0.0 <= out["test_map"] <= 1.0
    for name in ("pair_maps_fwd", "pair_maps_bwd_w", "pair_maps_bwd_qa",
                 "maxsim_bf16"):
        assert got[name] >= 1, (name, got)


def test_retrieval_1m_twin_on_the_card_equals_the_cpu(tmp_path):
    """The int8 leg launches ``maxsim_int8`` and gives query 0 the CPU
    run's top-10 scores (printed to 3 decimals; ties may swap ids); IVF
    probing every cluster is exact."""
    dev = _cuda()
    from mms_answer_selection_tpu_torch.examples import retrieval_1m

    argv = ["--pool", "8192", "--queries", "16"]
    card, got = _launches(lambda: retrieval_1m.main(argv))
    cpu = retrieval_1m.main(argv, device="cpu")
    assert got["maxsim_int8"] >= 1 and card["device"] == dev.type
    for (_, v_card), (_, v_cpu) in zip(card["top_k_query0"],
                                       cpu["top_k_query0"]):
        assert abs(v_card - v_cpu) <= 2e-3
    ivf, got = _launches(lambda: retrieval_1m.main(
        ["--pool", "8192", "--queries", "16", "--ivf-clusters", "8",
         "--nprobe", "8", "--coarse-shortlist", "8192"]))
    assert got["maxsim_bf16"] >= 1
    assert ivf["ivf"]["recall@10"] == 1.0
    assert ivf["coarse"]["recall@10"] == 1.0


# ------------------------------------------------------------ graph chunks
# A chunk of K training steps is one CUDA graph replay
# (``training/dispatch.py``).  Against K eager ``_train_step`` calls from
# the same carry, with dropout on (the registered generators re-seeded as
# the eager step seeds its own): each step's loss within 1e-5 relative,
# params within rtol 1e-4 + atol 1e-5, the conv biases within AdaDelta's
# band of 2 x lr_mult 2 x its normalized step a step (their gradient is
# rounding noise under train-mode BN, and the embedding gradient's scatter
# sums in the order its atomics land, so two runs on one card part in the
# last bits).
GRAPH_ADADELTA_STEP = (5e-7 / 0.05) ** 0.5


def _graph_trainer(dev, batch=50, **cfg_kw):
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)

    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                              sim_weight_init="xavier", **cfg_kw)
    tcfg = TrainerConfig(solver=SolverConfig(), batch_size=batch,
                         test_interval=5, train_loss_record_interval=1)
    return Trainer(cfg, tcfg, device=dev)


def _graph_batches(dev, n, batch=50, seed=4):
    g = torch.Generator().manual_seed(seed)
    return [{"question": torch.randint(0, 500, (batch, 40), generator=g),
             "answer": torch.randint(0, 500, (batch, 40), generator=g),
             "overlap_feat": torch.rand((batch, 2), generator=g),
             "label": (torch.rand((batch,), generator=g) < 0.3).int()}
            for _ in range(n)]


def _stack(batches, dev):
    return {k: torch.stack([b[k] for b in batches]).to(dev)
            for k in batches[0]}


def _assert_steps_close(got_losses, want_losses, got_p, want_p, steps):
    from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

    rel = (got_losses - want_losses).abs() / want_losses.abs()
    assert float(rel.max()) <= 1e-5, rel
    band = 2 * 2 * GRAPH_ADADELTA_STEP * steps
    for name in want_p:
        for k, want in want_p[name].items():
            got = got_p[name][k]
            if name.startswith("conv") and k == "b":
                assert float((got - want).abs().max()) <= band, (name, k)
            else:
                assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
                    (name, k, float((got - want).abs().max()))
    assert len(tree_leaves(got_p)) == len(tree_leaves(want_p))


def test_graph_chunk_matches_eager_steps_with_dropout():
    dev = _cuda()
    tr = _graph_trainer(dev)
    p0, s0, o0 = tr.init()
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in _graph_batches(dev, 5)]
    p, s, o, want = p0, s0, o0, []
    for i, b in enumerate(batches):
        p, s, o, loss = tr._train_step(p, s, o, b, 3 + i)
        want.append(loss)
    gp, gs, go, got = tr.scan_train_steps(p0, s0, o0, _stack(batches, dev),
                                          3)
    torch.cuda.synchronize()
    assert tr.runner.captures and tr.runner.replays == 1
    _assert_steps_close(got, torch.stack(want), gp, p, 5)


def test_launch_counts_are_replays_times_the_tally():
    dev = _cuda()
    tr = _graph_trainer(dev)
    carry = tr.init()
    stacked = _stack([{k: v.to(dev) for k, v in b.items()}
                      for b in _graph_batches(dev, 4)], dev)
    carry = tr.scan_train_steps(*carry, stacked, 0)[:3]   # captures K = 4
    (stats,) = tr.runner.stats()
    assert stats["tally"] == {"pair_maps_fwd": 4, "pair_maps_bwd_qa": 4,
                              "pair_maps_bwd_w": 4}
    before = dict(T.LAUNCH_COUNTS)
    for step in (4, 8, 12):
        carry = tr.scan_train_steps(*carry, stacked, step)[:3]
    assert {k: T.LAUNCH_COUNTS[k] - before[k] for k in before} == {
        k: 3 * stats["tally"].get(k, 0) for k in before}
    assert tr.runner.stats()[0]["replays"] == 4


def test_a_reseeded_registered_generator_replays_from_offset_zero():
    dev = _cuda()
    gen = torch.Generator(device=dev)
    out = torch.empty((3, 4099), device=dev)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    gen.manual_seed(1)
    torch.rand(8, generator=gen, device=dev)          # warm-up draw
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for i in range(3):
            out[i].copy_(torch.rand(4099, generator=gen, device=dev))
    for seed in (5, 5, 11):
        gen.manual_seed(seed)
        graph.replay()
        fresh = torch.Generator(device=dev).manual_seed(seed)
        want = torch.stack([torch.rand(4099, generator=fresh, device=dev)
                            for _ in range(3)])
        assert torch.equal(out, want), seed


def test_a_host_sync_in_the_step_fails_to_capture_and_raises():
    dev = _cuda()
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_apply
    from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

    def syncing(*args, **kw):
        out, state = mms_qa_apply(*args, **kw)
        if float(out["loss"]) < 0:                   # a host sync
            raise AssertionError("negative loss")
        return out, state

    tr = _graph_trainer(dev)
    tr.apply_fn = syncing
    carry = tr.init()
    stacked = _stack(_graph_batches(dev, 2), dev)
    for _ in range(2):                               # nothing is cached
        with pytest.raises(RuntimeError, match="capturing a 2-step chunk"
                           r"(.|\n)*float\(out"):
            tr.scan_train_steps(*carry, stacked, 0)
    assert tr.runner.replays == 0 and tr.runner.stats() == []
    for got, want in zip(tree_leaves(dict(enumerate(tr.runner.carry))),
                         tree_leaves(dict(enumerate(carry)))):
        assert torch.equal(got, want)                # no step ran
    loss = tr._train_step(*carry, {k: v[0] for k, v in stacked.items()},
                          0)[3]
    assert torch.isfinite(loss)                      # the card still works


def test_fit_and_fit_stream_chunks_are_graph_replays():
    """Every chunk one replay: ``fit`` at K = 4 with evals every 5 steps
    (chunks of 1 and 4), ``fit_stream`` over 13 batches (a partial chunk of
    2 at the end gets a graph of its own); the history is K = 1's on the
    card within the eager tolerances."""
    dev = _cuda()
    import numpy as np

    rng = np.random.default_rng(6)

    def rows(n):
        return {"question": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "answer": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "overlap_feat": rng.random((n, 2)).astype(np.float32),
                "label": (rng.random(n) < 0.3).astype(np.int32)}

    train, dev_split = rows(300), rows(60) | {"group": np.repeat(
        np.arange(6), 10)}
    runs = {}
    for k in (1, 4):
        tr = _graph_trainer(dev)
        tr.cfg = dataclasses.replace(tr.cfg, max_iter=16)
        runs[k] = tr.fit(train, dev_split, steps_per_dispatch=k)
        chunks = 16 if k == 1 else 7   # 0 | 1-4 | 5 | 6-9 | 10 | 11-14 | 15
        assert tr.runner.replays == chunks, tr.runner.stats()
    assert runs[4]["steps"] == runs[1]["steps"] == [0, 5, 10, 15]
    np.testing.assert_allclose(runs[4]["train_loss"], runs[1]["train_loss"],
                               rtol=1e-5)

    tr = _graph_trainer(dev)
    batches = iter([{k: v[i * 50:(i + 1) * 50] for k, v in train.items()}
                    for i in range(6)] * 2 + [{k: v[:50] for k, v in
                                                train.items()}])
    hist = tr.fit_stream(batches, dev_split, steps=40, eval_interval=5,
                         steps_per_dispatch=4)
    assert len(hist["train_loss"]) == 13 and hist["steps"] == [0, 5, 10]
    assert sorted((c["k"], c["replays"]) for c in tr.runner.stats()) == \
        [(1, 3), (2, 1), (4, 2)]
    assert tr.runner.replays == 6


def test_caption_model_chunk_captures_and_matches_eager():
    dev = _cuda()
    from mms_answer_selection_tpu_torch.models import (
        caption_image_apply, caption_image_init)
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)

    cfg, batch = _caption_step_inputs()
    tr = Trainer(cfg, TrainerConfig(solver=SolverConfig(weight_decay=0.0),
                                    batch_size=50), device=dev,
                 apply_fn=caption_image_apply, init_fn=caption_image_init)
    p0, s0, o0 = tr.init()
    b = {k: v.to(dev) for k, v in batch.items()}
    p, s, o, want = p0, s0, o0, []
    for i in range(3):
        p, s, o, loss = tr._train_step(p, s, o, b, i)
        want.append(loss)
    stacked = {k: torch.stack([v] * 3) for k, v in b.items()}
    gp, _, _, got = tr.scan_train_steps(p0, s0, o0, stacked, 0)
    assert tr.runner.replays == 1
    assert set(tr.runner.stats()[0]["tally"]) == {
        "pair_maps_fwd", "pair_maps_bwd_qa", "pair_maps_bwd_w"}
    # within 1e-5 relative; a hinge loss of exactly 0 (every positive
    # past the margin) must be 0 in both
    assert torch.allclose(got, torch.stack(want), rtol=1e-5, atol=0.0), \
        (got, want)
    band = 2 * 2 * GRAPH_ADADELTA_STEP * 3
    for name in p:
        for k, w in p[name].items():
            diff = float((gp[name][k] - w).abs().max())
            if name.startswith("conv") and k == "b":
                assert diff <= band, (name, k, diff)
            else:
                assert diff <= 1e-4 * max(float(w.abs().max()), 1e-30), \
                    (name, k, diff)


# ------------------------------------------------- one-dispatch serving
# (utils/graphs.py): query's chunk scan, query_rerank, query_ivf,
# query_coarse and the eval step, each one CUDA graph replay; the same
# kernels as the eager calls, so the same bits
def _engine_pair(pool_dtype, chunk=700, **build):
    dev = _cuda()
    cfg, params, state, cand, g = _v4_engine_inputs()
    queries = torch.randint(0, 500, (6, 40), generator=g)
    graphed, eager = (QueryEngine(params, cfg, pool_dtype=pool_dtype,
                                  chunk_size=chunk, scan_chunks=scan,
                                  device=dev).build_index(cand, **build)
                      for scan in (True, False))
    return graphed, eager, state, queries, cand


def _paths(eng, state, q):
    out = {"query": eng.query(q, k=10), "query 1": eng.query(q[:1], k=10),
           "rerank": eng.query_rerank(state, q, k=5, shortlist=20)}
    if eng.ivf is not None:
        out["ivf"] = eng.query_ivf(q, k=10, nprobe=4)
        out["coarse"] = eng.ivf.query_coarse(q, k=10, shortlist=256)
    return out


def _assert_same_paths(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for a, b in zip(got[name], want[name], strict=True):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_served_paths_replay_the_eager_calls_bit_for_bit(pool_dtype):
    graphed, eager, state, q, _ = _engine_pair(pool_dtype)
    if pool_dtype != "int4":
        for eng in (graphed, eager):
            eng.build_ivf(n_clusters=16, seed=0, coarse_tokens=4)
    want = _paths(eager, state, q)
    for _ in range(2):                        # the capture, then a replay
        _assert_same_paths(_paths(graphed, state, q), want)
    assert graphed._calls.captures and not eager._calls.keys()
    assert all(s["replays"] == 2 for s in graphed._calls.stats())


def test_keys_replayed_out_of_capture_order_equal_eager():
    graphed, eager, state, q, _ = _engine_pair("int8")
    for eng in (graphed, eager):
        eng.build_ivf(n_clusters=16, seed=0, coarse_tokens=4)
    calls = [("q6", lambda e: e.query(q, k=10)),
             ("q1", lambda e: e.query(q[:1], k=10)),
             ("k3", lambda e: e.query(q[:3], k=3)),
             ("rr", lambda e: e.query_rerank(state, q[:2], k=4,
                                             shortlist=12)),
             ("ivf", lambda e: e.query_ivf(q[:2], k=10, nprobe=4)),
             ("coarse", lambda e: e.ivf.query_coarse(q[:2], k=10,
                                                     shortlist=256))]
    want = {n: fn(eager) for n, fn in calls}
    for n, fn in calls:                        # captured in this order
        fn(graphed)
    for i in (5, 3, 1, 4, 0, 2, 1, 5):
        n, fn = calls[i]
        assert all(torch.equal(a, b) for a, b in zip(fn(graphed), want[n])), n


def test_query_launches_are_replays_times_the_tally():
    graphed, _, state, q, _ = _engine_pair("bf16")
    graphed.build_ivf(n_clusters=16, seed=0, coarse_tokens=4)
    paths = [lambda: graphed.query(q, k=10),
             lambda: graphed.query_rerank(state, q, k=5, shortlist=20),
             lambda: graphed.query_ivf(q, k=10, nprobe=4),
             lambda: graphed.ivf.query_coarse(q, k=10, shortlist=256)]
    for path in paths:                         # captures
        path()
    tallies = {s["key"][0]: s["tally"] for s in graphed._calls.stats()}
    assert tallies == {"query": {"maxsim_bf16": 5},   # 3,000 in 700s
                       "rerank": {"maxsim_bf16": 5, "pair_maps_fwd": 1},
                       "ivf": {"maxsim_bf16": 6},     # one a query
                       "coarse": {"maxsim_bf16": 7}}  # + the mini pool
    before = dict(T.LAUNCH_COUNTS)
    for _ in range(3):
        for path in paths:
            path()
    assert {k: T.LAUNCH_COUNTS[k] - before[k] for k in before} == {
        k: 3 * sum(t.get(k, 0) for t in tallies.values()) for k in before}


def test_a_host_copy_in_a_captured_query_raises_naming_the_line():
    graphed, eager, _, q, _ = _engine_pair("int8")
    tokens = graphed._tokens

    def copying(query):
        shift = torch.tensor([0.0], device=query.device)   # host -> device
        return tokens(query) + shift

    graphed._tokens = copying
    for _ in range(2):                         # nothing is cached
        with pytest.raises(RuntimeError, match=r"capturing engine "
                           r"(.|\n)*torch\.tensor\(\[0\.0\]"):
            graphed.query(q, k=10)
    assert graphed._calls.keys() == []
    graphed._tokens = tokens
    assert all(torch.equal(a, b) for a, b in zip(graphed.query(q, k=10),
                                                 eager.query(q, k=10)))


def test_a_host_copy_in_a_captured_eval_raises_naming_the_line():
    import numpy as np

    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_apply

    def copying(params, state, batch, cfg, **kw):
        out, state = mms_qa_apply(params, state, batch, cfg, **kw)
        shift = torch.tensor([0.0], device=out["prob"].device)   # a copy
        return {**out, "prob": out["prob"] + shift}, state

    dev = _cuda()
    tr = _graph_trainer(dev)
    p, s, _ = tr.init()
    tr.apply_fn = copying
    rng = np.random.default_rng(2)
    batch = tr._full_batch({
        "question": rng.integers(0, 500, (40, 40)).astype(np.int32),
        "answer": rng.integers(0, 500, (40, 40)).astype(np.int32),
        "overlap_feat": rng.random((40, 2)).astype(np.float32),
        "label": (rng.random(40) < 0.3).astype(np.int32),
        "group": np.repeat(np.arange(4), 10)})
    with pytest.raises(RuntimeError, match=r"capturing eval step "
                       r"(.|\n)*torch\.tensor\(\[0\.0\]"):
        tr._eval_step(p, s, batch)
    assert tr.evals.keys() == []
    tr.apply_fn = mms_qa_apply
    assert torch.isfinite(tr._eval_step(p, s, batch)["map"])


def test_graphs_follow_the_lifecycle_and_tombstones_never_surface():
    graphed, eager, state, q, cand = _engine_pair("int8", reserve=50)
    dead = sorted(set(eager.query(q, k=3)[1].flatten().tolist()) | {0, 7})
    steps = [("add past the reserve", lambda e: e.add_candidates(
                  cand[:80].to(e.device))),
             ("remove", lambda e: e.remove_candidates(dead)),
             ("compact", lambda e: e.compact())]
    for what, op in steps:
        for eng in (graphed, eager):
            op(eng)
        got, want = _paths(graphed, state, q), _paths(eager, state, q)
        _assert_same_paths(got, want)
        if what == "remove":
            assert not set(got["query"][1].flatten().tolist()) & set(dead)
            assert not set(got["rerank"][1].flatten().tolist()) & set(dead)


def test_server_buckets_bound_the_graphs_and_keep_the_replies():
    from mms_answer_selection_tpu_torch.serve import QAServer

    graphed, eager, state, _, _ = _engine_pair("int8")
    g = torch.Generator().manual_seed(9)
    rows = torch.randint(0, 500, (33, 40), generator=g)
    for pad, graphs in ((True, 7), (False, 33)):
        graphed._calls.drop()
        srv = QAServer(graphed, state=state, pad_buckets=pad)
        try:
            for n in range(1, 34):
                vals, idx = srv._dispatch_group((10, 0, 0), rows[:n].numpy())
                want = eager.query(rows[:n], k=10)
                assert (vals == want[0].cpu().numpy()).all() \
                    and (idx == want[1].cpu().numpy()).all(), (pad, n)
        finally:
            srv.close()
        assert len(graphed._calls.keys()) == graphs, pad


def test_eval_step_replays_bit_for_bit_and_fit_evals_are_replays():
    import numpy as np

    dev = _cuda()
    tr = _graph_trainer(dev)
    p, s, _ = tr.init()
    rng = np.random.default_rng(8)

    def split(n):
        return {"question": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "answer": rng.integers(0, 500, (n, 40)).astype(np.int32),
                "overlap_feat": rng.random((n, 2)).astype(np.float32),
                "label": (rng.random(n) < 0.3).astype(np.int32),
                "group": np.repeat(np.arange(n // 10 + 1), 10)[:n]}

    for n in (120, 2100):                      # pairwise, sorted metrics
        batch = tr._full_batch(split(n))
        want = tr._eval_body(p, s, batch)
        for _ in range(2):
            got = tr._eval_step(p, s, batch)
            for k in ("prob", "mrr", "auc", "loss"):
                assert (got[k] is want[k] is None) \
                    or torch.equal(got[k], want[k]), (n, k)
            # the sorted MAP sums each group's precisions with index_add_,
            # whose float atomics land in any order: held to 1e-6
            assert abs(float(got["map"]) - float(want["map"])) <= (
                0.0 if n <= 2048 else 1e-6), n
    assert tr.evals.replays == 4 and len(tr.evals.keys()) == 2
    tr = _graph_trainer(dev)
    tr.cfg = dataclasses.replace(tr.cfg, max_iter=16)
    tr.fit(split(300), split(60), test_data=split(70), steps_per_dispatch=4)
    # evals at steps 0, 5, 10, 15 on dev and test: two keys, 8 replays
    assert tr.evals.replays == 8 and len(tr.evals.keys()) == 2


# ------------------------------------------------ the generic path's graphs
# Every GraphSolver iteration, test batch, pycaffe forward, ``nettest`` and
# ``extract_features`` iteration is one CUDA graph replay
# (``training/dispatch.StepRunner``, ``utils/graphs.GraphedCall``).  Held
# to the eager code bit for bit: a step under torch's deterministic
# algorithms (by default the embedding gradient's scatter sums in the order
# its atomics land, so two eager steps part in the last bits), the
# forwards as they are.
GENERIC_SOLVER = """net: "train.prototxt"
type: "AdaDelta" base_lr: 1.0 momentum: 0.95 delta: 5e-7
weight_decay: 5e-4 lr_policy: "fixed" max_iter: 100 random_seed: 3
display: 0 average_loss: 1 snapshot_prefix: "{prefix}" iter_size: {iter_size}
"""


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _generic_feeds(n=200, batch=50, seed=5):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"data": {
        "question": rng.integers(0, 500, (n, 40)).astype(np.int32),
        "answer": rng.integers(0, 500, (n, 40)).astype(np.int32),
        "overlap_feat": rng.random((n, 2)).astype(np.float32),
        "label": (rng.random(n) < 0.3).astype(np.int32),
        "group": np.repeat(np.arange(n // 10), 10).astype(np.int32),
        "batch_size": batch, "shuffle": False}}


def _generic_solver(tmp_path, dev, *, iter_size=1, batch=50, test=False):
    """The V4 recipe's train net (dropout on, a xavier W) at vocab 500 under
    an AdaDelta solver; with ``test`` its eval net as the test net."""
    from mms_answer_selection_tpu_torch.training.graph_solver import (
        GraphSolver)
    from mms_answer_selection_tpu_torch.utils.prototxt import (
        net_prototxt_from_config)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(TM.V4, vocab_size=500,
                              sim_weight_init="xavier")
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "train.prototxt").write_text(
        net_prototxt_from_config(cfg, batch_size=batch))
    text = GENERIC_SOLVER.format(prefix=tmp_path / "g", iter_size=iter_size)
    if test:
        (tmp_path / "eval.prototxt").write_text(
            net_prototxt_from_config(cfg, phase="eval", batch_size=batch))
        text += 'test_net: "eval.prototxt" test_iter: 2\n'
    (tmp_path / "solver.prototxt").write_text(text)
    return GraphSolver(str(tmp_path / "solver.prototxt"),
                       feeds=_generic_feeds(batch=batch), device=dev)


def _solver_leaves(gs):
    from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

    return tree_leaves({"p": gs.params, "s": gs.state, "o": gs.opt_state})


def _replay_and_eager(a, b, steps):
    """``steps`` iterations of ``a`` through ``step`` (replays) and of ``b``
    through the eager ``_train_step``: their losses."""
    got, want = [], []
    for _ in range(steps):
        a.step(1)
        got.append(a._smoothed)
        want.append(float(b._train_step()[0]))
        b.iter_ += 1
    return got, want


@pytest.mark.parametrize("iter_size", [1, 2])
def test_generic_step_replays_the_eager_step_bit_for_bit(tmp_path,
                                                         iter_size):
    dev = _cuda()
    a = _generic_solver(tmp_path / "a", dev, iter_size=iter_size)
    b = _generic_solver(tmp_path / "b", dev, iter_size=iter_size)
    with _deterministic():
        got, want = _replay_and_eager(a, b, 3)
    assert got == want
    assert all(torch.equal(x, y) for x, y in zip(_solver_leaves(a),
                                                 _solver_leaves(b)))
    assert a.runner.captures and a.runner.replays == 3


def test_generic_launches_are_replays_times_the_tally(tmp_path):
    dev = _cuda()
    gs = _generic_solver(tmp_path, dev, iter_size=2)
    gs.step(1)                                       # captures
    (stats,) = gs.runner.stats()
    assert stats["tally"] == {"pair_maps_fwd": 2, "pair_maps_bwd_qa": 2,
                              "pair_maps_bwd_w": 2}
    before = dict(T.LAUNCH_COUNTS)
    gs.step(4)
    assert {k: T.LAUNCH_COUNTS[k] - before[k] for k in before} == {
        k: 4 * stats["tally"].get(k, 0) for k in before}
    assert gs.runner.replays == 5


def test_test_pass_replays_its_eager_pass(tmp_path):
    dev = _cuda()
    a = _generic_solver(tmp_path / "a", dev, test=True)
    b = _generic_solver(tmp_path / "b", dev, test=True)
    with _deterministic():
        _replay_and_eager(a, b, 2)
    got = a._test_means(0, a._test_outputs)
    want = b._test_means(0, b._test_outputs_eager)
    assert got.keys() == want.keys() == {"loss", "map", "mrr", "auc"}
    assert all((got[k] == want[k]).all() for k in want)
    (stats,) = a.forwards.stats()                    # test_iter 2
    assert stats["replays"] == 2 and stats["tally"] == {"pair_maps_fwd": 1}


def test_pycaffe_forwards_replay_the_eager_forwards(tmp_path):
    from mms_answer_selection_tpu_torch.models.pynet import Net

    dev = _cuda()
    _generic_solver(tmp_path, dev)                   # writes the net
    text = (tmp_path / "train.prototxt").read_text()
    feeds = _generic_feeds()["data"]
    batch = {k: torch.as_tensor(feeds[k][:50]) for k in
             ("question", "answer", "overlap_feat", "label")}
    graphed, eager = Net(text, phase="train", device=dev), \
        Net(text, phase="train", device=dev)
    eager.forwards.captures = False
    for net in (graphed, eager):                     # same seed: same init
        net.forward(**batch)
    got, want = [], []
    for net, out in ((graphed, got), (eager, want)):
        for _ in range(2):                           # dropout, BN moving
            out.append({k: b.tensor for k, b in net.forward(**batch).items()})
        out.append({k: b.tensor for k, b in net.forward(
            start="conv0", end="fc2").items()})
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[k], w[k]) for k in w)
    for layer, sub in eager.state.items():
        for k, v in sub.items():
            assert torch.equal(graphed.state[layer][k], v), (layer, k)
    assert graphed.forwards.replays == 4 and len(graphed.forwards.keys()) == 2


def test_nettest_and_extract_features_replay_their_eager_calls(tmp_path,
                                                               capsys):
    import json

    import numpy as np

    from mms_answer_selection_tpu_torch import cli as tcli
    from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
    from mms_answer_selection_tpu_torch.utils.graphs import on_device
    from mms_answer_selection_tpu_torch.utils.seed import derive_seed

    dev = _cuda()
    gs = _generic_solver(tmp_path, dev, test=True)
    gs.step(3)
    model, _ = gs.snapshot()
    eval_path = tmp_path / "eval.prototxt"
    feeds = _generic_feeds()["data"]
    keys = ("question", "answer", "label", "group", "overlap_feat")
    batches = [{k: feeds[k][i:i + 50] for k in keys} for i in (0, 50)]
    real = tcli._test_feeds
    tcli._test_feeds = lambda *_: [iter(batches * 2)]
    try:
        tcli.main(["nettest", "--model", str(eval_path), "--weights", model,
                   "--iterations", "2", "--device", "cuda"])
        nt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        tcli.main(["extract_features", "--model", str(eval_path),
                   "--weights", model, "--blobs", "prob,fc2",
                   "--iterations", "2", "--out", str(tmp_path / "f"),
                   "--device", "cuda"])
    finally:
        tcli._test_feeds = real
    net = GraphNet(eval_path.read_text(), phase="test")
    p, s = gs._shared_test_trees(0)
    body = tcli._nettest_forward(net, p, s)
    fbody = tcli._features_forward(net, p, s, ["prob", "fc2"])
    with torch.no_grad():
        outs = [body(on_device(b, dev)) for b in batches]
        feats = [fbody(on_device(b, dev), generators=[
            torch.Generator(device=dev).manual_seed(
                derive_seed(0, 0xFEA7, i))]) for i, b in enumerate(batches)]
    for k in ("map", "mrr", "auc"):             # the CLI's arithmetic
        want = np.ravel((outs[0][k] + outs[1][k]).cpu().numpy()) / 2
        assert nt[k] == float(want[0]), k
    for b in ("prob", "fc2"):
        got = np.load(tmp_path / "f" / f"{b}.npy")
        assert np.array_equal(got, np.concatenate(
            [f[b].cpu().numpy() for f in feats])), b


def test_a_syncing_python_layer_fails_to_capture_naming_its_line(
        tmp_path, monkeypatch):
    from mms_answer_selection_tpu_torch.models.pynet import Net

    dev = _cuda()
    (tmp_path / "syncing_layer.py").write_text(
        "def forward(x):\n"
        "    if float(x.sum()) < -1e30:   # a host sync\n"
        "        raise ValueError('huge')\n"
        "    return x * 2\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    net = Net("""
    input: "data" input_shape { dim: 4 dim: 8 }
    layer { name: "py" type: "Python" bottom: "data" top: "out"
      python_param { module: "syncing_layer" layer: "forward" } }
    """, device=dev)
    for _ in range(2):                               # nothing is cached
        with pytest.raises(RuntimeError, match=r"capturing pycaffe forward"
                           r"(.|\n)*syncing_layer.py:2 \(if float"):
            net.forward(data=torch.ones(4, 8))
    assert net.forwards.keys() == [] and net.forwards.replays == 0
    assert torch.equal(net._net.apply({}, {}, {"data": torch.ones(
        4, 8, device=dev)})[0]["out"], torch.full((4, 8), 2.0, device=dev))


def test_weights_replaced_mid_run_then_steps_equal_eager(tmp_path):
    dev = _cuda()
    a = _generic_solver(tmp_path / "a", dev)
    b = _generic_solver(tmp_path / "b", dev)
    other = _generic_solver(tmp_path / "o", dev)
    other.step(4)
    model, _ = other.snapshot()
    with _deterministic():
        _replay_and_eager(a, b, 2)
        runner = a.runner
        for gs in (a, b):
            gs.copy_weights(model)
            gs.params["fc1"]["w"].mul_(0.5)          # a write in place
        got, want = _replay_and_eager(a, b, 2)
    assert got == want
    assert all(torch.equal(x, y) for x, y in zip(_solver_leaves(a),
                                                 _solver_leaves(b)))
    assert a.runner is runner and a.runner.replays == 4
