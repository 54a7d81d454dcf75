"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports no JAX, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: ``KERNEL_VS_PLAIN_RTOL`` of the row's max |score| (reasons
beside its definition in ``ops/sim_cross_kernels.py``); masked int8
candidates must score the mask exactly.
"""

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
          (70, 200, 40, 40, 4, 50), (5, 64, 24, 6, 2, 100)]


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
    assert T.LAUNCH_COUNTS == n0


def test_topk_tie_rule_on_cuda():
    dev = _cuda()
    s = torch.zeros((3, 5000), device=dev)
    s[:, 4000] = 1.0
    vals, idx = topk(s, 7)
    assert idx[:, 0].tolist() == [4000] * 3
    assert idx[:, 1:].tolist() == [[0, 1, 2, 3, 4, 5]] * 3


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_engine_on_cuda_matches_engine_on_cpu(pool_dtype):
    dev = _cuda()
    cfg = dataclasses.replace(TM.MMSQAConfig(), vocab_size=500,
                              sim_weight_init="xavier")
    params, state = TM.mms_qa_init(cfg, generator=torch.Generator()
                                   .manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params["embed"]["w"] = torch.randn((500, 50), generator=g) * 0.3
    state = {k: {"mean": v["mean"], "var": v["var"] + 1.0}
             for k, v in state.items()}
    cand = torch.randint(0, 500, (3000, 40), generator=g)
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


# ------------------------------------------------------------ pair maps
# (N, W1, W2, D, M): V4 at batch 50, a ragged batch of 7 and of 1, V4_WIDE's
# D = 300, and the kernels' edges (W = 64, D not a multiple of 32, M = 1)
PAIR_SHAPES = [(50, 40, 40, 50, 4), (7, 40, 40, 50, 4), (1, 40, 40, 50, 4),
               (50, 40, 40, 300, 4), (7, 40, 40, 300, 4),
               (3, 64, 5, 33, 1), (2, 9, 64, 70, 3)]


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


def test_pair_map_dw_is_deterministic():
    dev = _cuda()
    q, a, w, g = _pair_operands(dev, 50, 40, 40, 50, 4)
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
    n0 = dict(T.LAUNCH_COUNTS)
    with pytest.raises(ValueError):          # W1 > 64
        T.bilinear_pair_maps(q, a, w)
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
