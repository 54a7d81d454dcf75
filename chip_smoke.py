#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths (``mms_answer_selection_tpu_torch``) once
at the V4 recipe's widths, after building the hand-written kernels from
``mms_answer_selection_tpu_torch/csrc``:

* serving: holds the MaxSim kernels against their plain PyTorch versions,
  builds a 262,144-candidate bf16 and int8 ``QueryEngine`` over random
  weights made from a seed, answers 256 queries and a rerank on each, and
  checks the answers against a brute-force plain scoring and the rerank's
  probabilities against the same pairs scored on the CPU;
* training: holds the pair-map forward and backward kernels against their
  plain versions at V4 and V4_WIDE widths and at every batch size the
  main paths give them (and dW against itself, bit for bit), one train
  step on the card against the same step on the CPU, then ``Trainer.fit``
  on a synthetic corpus of the recipe's size (AdaDelta, batch 50, dev MAP
  every 100 steps), holding the best params' test-split probabilities
  against the CPU's and scoring them through ``trec_eval`` against the
  in-process MAP/MRR;

and times the kernels, the engine and the train step.

Exits non-zero, before printing any result, when no CUDA device is present
or any phase fails.  The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
its error against the plain version and both times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SEED = 0
D, W1, W2, M = 50, 40, 40, 4      # V4: embed_dim, question/answer length
VOCAB = 50_000
POOL = 262_144
N_QUERIES, N_RERANK, K, SHORTLIST = 256, 32, 10, 50
KERNEL_POOLS = (8192, 8192 + 37)  # one ragged: the last tile is partial
KERNEL_NQ = (1, 16, N_RERANK, N_QUERIES)  # latency, a batch, the main path
TIMED_NQ, TIMED_POOL = 16, 8192
FIT_STEPS, TEST_INTERVAL, BATCH = 301, 100, 50
# training: (N, D) pair-map checks at W1 = W2 = 40, M = 4: V4 at batch 50,
# ragged batches, the rerank's Nq x S pairs, V4_WIDE's D = 300 (the dev
# and test split sizes, which the evals give the kernel, join them once
# the corpus is made); the recipe-sized synthetic corpus
PAIR_CHECKS = ((BATCH, D), (7, D), (1, D), (N_RERANK * SHORTLIST, D),
               (BATCH, 300))
TRAIN_Q, DEV_Q, TEST_Q = 1250, 65, 68
# |P(correct)| card vs CPU on the same weights and pairs: float32 on both,
# only the summation order of the pair maps, convs and MLP differs
PROB_ATOL = 1e-4
STEP_BATCHES = (50, 256, 1024)
ADADELTA_STEP = (5e-7 / 0.05) ** 0.5   # lr * sqrt(delta / (1 - momentum))

ROOT = Path(__file__).resolve().parent
CSRC = "mms_answer_selection_tpu_torch/csrc/"
PALLAS = "mms_answer_selection_tpu/ops/sim_cross_pallas.py:"
KERNELS = {  # kernel -> (source, the TPU kernel it replaces)
    "maxsim_bf16": (CSRC + "maxsim_bf16.cu", PALLAS + "190"),
    "maxsim_int8": (CSRC + "maxsim_int8.cu", PALLAS + "534"),
    "pair_maps_fwd": (CSRC + "pair_maps.cu", PALLAS + "85"),
    "pair_maps_bwd_qa": (CSRC + "pair_maps.cu", PALLAS + "156"),
    "pair_maps_bwd_w": (CSRC + "pair_maps.cu", PALLAS + "156"),
}
MAXSIM = ("maxsim_bf16", "maxsim_int8")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms, each call ended by a device sync
    (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms from CUDA events (warm)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def train_phase(dev, normal, card: str, max_err: dict, timed: dict) -> dict:
    """The training path: pair-map kernels against their plain versions,
    one train step on the card against the CPU, ``fit`` on the recipe-sized
    synthetic corpus with the ``trec_eval`` cross-check, and the times.
    Fills ``max_err`` and ``timed`` for the pair-map kernels and returns
    the launch counts of the ``fit`` run."""
    import dataclasses
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch.data import (
        prepare_trec_qa, synthetic_split, synthetic_world)
    from mms_answer_selection_tpu_torch.metrics import (
        mean_average_precision, mean_reciprocal_rank, trec_eval,
        write_trec_files)
    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    # ------------------------------------------ recipe-sized corpus
    t0 = time.perf_counter()
    world = synthetic_world(vocab_words=22500, n_topics=250, dim=D, seed=22)
    splits, info = prepare_trec_qa(
        synthetic_split(world, TRAIN_Q, 30, 50, seed=101),
        synthetic_split(world, DEV_Q, 12, 24, seed=202),
        synthetic_split(world, TEST_Q, 15, 29, seed=303), world["w2v"])
    prep_s = time.perf_counter() - t0
    log(f"data: {({k: len(v['label']) for k, v in splits.items()})} pairs, "
        f"vocab {info['vocab_size']}, host prep {prep_s:.3f} s")

    # ------------------------------------- pair-map kernels vs plain
    def pair_operands(n, d):
        return (normal(n, W1, d, scale=0.3), normal(n, W2, d, scale=0.3),
                normal(M, d, d, scale=0.05), normal(n, W1, W2, M))

    grads_plain = sk.bilinear_pair_maps_grads_plain
    pairs = {  # kernel -> (wrapper, plain version), each giving a list
        "pair_maps_fwd": (lambda q, a, w, g: [sk.pair_maps_fwd(q, a, w)],
                          lambda q, a, w, g: [
                              sk.bilinear_pair_maps_plain(q, a, w)]),
        "pair_maps_bwd_qa": (lambda *o: list(sk.pair_maps_bwd_qa(*o)),
                             lambda *o: list(grads_plain(
                                 *o, need_w=False)[:2])),
        "pair_maps_bwd_w": (lambda *o: [sk.pair_maps_bwd_w(*o)],
                            lambda *o: [grads_plain(*o, need_qa=False)[2]]),
    }
    sizes = (len(splits["dev"]["label"]), len(splits["test"]["label"]))
    for n, d in PAIR_CHECKS + tuple((n, D) for n in sizes):
        ops = pair_operands(n, d)
        for name, (kernel, plain) in pairs.items():
            got = kernel(*ops)
            torch.cuda.synchronize()
            want = plain(*ops)
            torch.cuda.synchronize()
            rtol = sk.KERNEL_VS_PLAIN_RTOL[name]
            for x, y in zip(got, want):
                if x.shape != y.shape or not torch.isfinite(x).all():
                    raise AssertionError(f"{name}: bad output {x.shape}")
                err = float((x - y).abs().max())
                rel = err / float(y.abs().max())
                max_err[name] = max(max_err[name], err)
                log(f"check {name} N={n} D={d} out {tuple(x.shape)}: "
                    f"max_abs_err {err:.3e}, max_rel_err {rel:.3e} (rtol "
                    f"{rtol:g} of the output's max |value|)")
                if rel > rtol:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version: {rel:.3e} > {rtol:g}")
        if not torch.equal(sk.pair_maps_bwd_w(*ops), sk.pair_maps_bwd_w(*ops)):
            raise AssertionError(f"pair_maps_bwd_w: dW differs between two "
                                 f"runs at N={n} D={d}")
    log("check pair_maps_bwd_w: dW bit-identical across two runs at every "
        "shape")

    recipe = SolverConfig(solver_type="adadelta", base_lr=1.0, momentum=0.95,
                          delta=5e-7, weight_decay=5e-4)
    tcfg = TrainerConfig(solver=recipe, max_iter=FIT_STEPS, batch_size=BATCH,
                         test_interval=TEST_INTERVAL, seed=22)
    model = dataclasses.replace(V4, vocab_size=info["vocab_size"])

    # -------------------------------------- one step, card vs CPU
    # xavier W and no dropout: a well-conditioned step that both devices
    # compute without randomness.  Loss within 1e-5 relative; every param
    # within rtol 1e-4 + atol 1e-5, except the conv biases: each feeds a
    # train-mode BN, so its true gradient is 0 and each device moves it by
    # AdaDelta's normalized step (at most lr_mult 2 x ADADELTA_STEP) in a
    # direction set by rounding noise.
    still = dataclasses.replace(model, sim_weight_init="xavier",
                                sim_dropout=0.0, fc1_dropout=0.0)
    rows = {k: torch.as_tensor(v[:BATCH]) for k, v in splits["train"].items()
            if k != "group"}
    stepped = []
    for where in (torch.device("cpu"), dev):
        tr = Trainer(still, tcfg, device=where)
        p, s, o = tr.init(pretrained=info["pretrained"])
        res = tr._train_step(p, s, o, {k: v.to(where) for k, v in
                                       rows.items()}, 0)
        stepped.append(tree_map(lambda t: t.cpu(), dict(zip(
            ("p", "s", "o", "loss"), res))))
    cpu, gpu = stepped
    loss_rel = abs(float(gpu["loss"]) / float(cpu["loss"]) - 1)
    worst, band = 0.0, 2 * 2 * ADADELTA_STEP
    for name, sub in cpu["p"].items():
        for k, want in sub.items():
            got = gpu["p"][name][k]
            diff = float((got - want).abs().max())
            if name.startswith("conv") and k == "b":
                ok = diff <= band
            else:
                ok = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
                worst = max(worst, diff)
            if not ok:
                raise AssertionError(f"train step: {name}.{k} differs between "
                                     f"card and CPU by {diff:.3e}")
    log(f"check train step card vs CPU (V4, batch {BATCH}, xavier W, no "
        f"dropout): loss {float(gpu['loss']):.6f}, rel err {loss_rel:.3e} "
        f"(tol 1e-5); params max abs diff {worst:.3e} (rtol 1e-4, atol 1e-5;"
        f" conv biases within {band:.3e})")
    if loss_rel > 1e-5:
        raise AssertionError("train step: loss differs between card and CPU")

    # ------------------------------------- the training path, once
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    trainer = Trainer(model, tcfg, device=dev)
    t0 = time.perf_counter()
    hist = trainer.fit(splits["train"], splits["dev"],
                       test_data=splits["test"],
                       pretrained=info["pretrained"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCH_COUNTS)
    log(f"launches on the training path: {launches}")
    for name in pairs:
        if launches[name] < 1:
            raise AssertionError(f"the training path never launched {name}")
    losses = np.asarray(hist["train_loss"])
    dev_map = np.asarray(hist["dev_map"])
    if not np.isfinite(losses).all() or not losses[-5:].mean() < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    if hist["steps"] != list(range(0, FIT_STEPS, TEST_INTERVAL)) \
            or not (np.isfinite(dev_map).all() and (dev_map >= 0).all()
                    and (dev_map <= 1 + 1e-6).all()):
        raise AssertionError(f"dev MAP not evaluated as planned: "
                             f"{hist['steps']} {dev_map}")
    log(f"fit: {FIT_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-5:].mean():.4f} (mean of the last 5 records), dev MAP "
        f"{[round(float(x), 4) for x in dev_map]} at {hist['steps']}, best "
        f"{hist['best_dev_map']:.4f} @ {hist['best_step']}, test MAP "
        f"{[round(float(x), 4) for x in hist['test_map']]}")

    res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
    on_cpu = Trainer(model, tcfg, device="cpu").evaluate(
        tree_map(lambda t: t.cpu(), hist["params"]),
        tree_map(lambda t: t.cpu(), hist["state"]), splits["test"])
    prob_err = float(np.abs(res["prob"] - on_cpu["prob"]).max())
    log(f"check evaluate card vs CPU on the test split "
        f"({len(splits['test']['label'])} pairs, best params): max abs "
        f"P diff {prob_err:.3e} (tol {PROB_ATOL:g})")
    if prob_err > PROB_ATOL:
        raise AssertionError("evaluate: card and CPU probabilities differ")
    scores = res["prob"][:, 1].astype(np.float64)
    labels, groups = splits["test"]["label"], splits["test"]["group"]
    with tempfile.TemporaryDirectory() as tmp:
        truth, result = Path(tmp) / "truth", Path(tmp) / "result"
        write_trec_files(truth, result, scores, labels, groups)
        ev = trec_eval(truth, result)
    np_map = mean_average_precision(scores, labels, groups)
    np_mrr = mean_reciprocal_rank(scores, labels, groups)
    log(f"test split: trec_eval MAP {ev['map']:.6f} MRR "
        f"{ev['recip_rank']:.6f}; in-process MAP {float(res['map']):.6f} "
        f"MRR {float(res['mrr']):.6f}; numpy MAP {np_map:.6f}")
    if abs(ev["map"] - float(res["map"])) > 1e-5 \
            or abs(ev["recip_rank"] - float(res["mrr"])) > 1e-5 \
            or abs(ev["map"] - np_map) > 1e-9 \
            or abs(ev["recip_rank"] - np_mrr) > 1e-9:
        raise AssertionError("trec_eval disagrees with the in-process metrics")

    # ---------------------------------------------------------------- times
    ops = pair_operands(BATCH, D)
    for name, (kernel, plain) in pairs.items():
        timed[name] = (event_ms(lambda: kernel(*ops), 50),
                       event_ms(lambda: plain(*ops), 20))
        log(f"time {name} at N={BATCH}, W1=W2={W1}, D={D}, M={M}: kernel "
            f"{timed[name][0]:.4f} ms, plain {timed[name][1]:.4f} ms [{card}]")
    train = trainer._full_batch({k: v for k, v in splits["train"].items()
                                 if k != "group"})
    for b in STEP_BATCHES:
        tr = Trainer(model, dataclasses.replace(tcfg, batch_size=b),
                     device=dev)
        p, s, o = tr.init(pretrained=info["pretrained"])
        batch = next(tr._epoch_batches(train, 0))
        ms = sync_ms(lambda: tr._train_step(p, s, o, batch, 0),
                     max(5, 2000 // b))
        log(f"time train step V4 batch {b}: p50 {ms:.3f} ms, "
            f"{1e3 / ms:.2f} steps/s, {b * 1e3 / ms:.0f} pairs/s [{card}]")
    log(f"time fit {FIT_STEPS} steps at batch {BATCH} with "
        f"{len(hist['steps'])} dev+test evals: {fit_s:.3f} s "
        f"({FIT_STEPS / fit_s:.2f} steps/s); host data prep {prep_s:.3f} s "
        f"[{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        MMSQAConfig, mms_qa_apply, mms_qa_init)
    from mms_answer_selection_tpu_torch.ops import _build
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.serve import QueryEngine
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    # ---------------------------------------------------------- environment
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- build
    so, build_s = _build.build()
    _build.load_library()
    log(f"build: {so.name} in {build_s:.3f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            log(f"  {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # ---------------------------------------- kernel vs plain at serving widths
    w_rand = normal(M, D, D, scale=0.05)
    max_err = {name: 0.0 for name in KERNELS}
    timed = {}

    def operands(name, nq, c):
        q = normal(nq, W1, D, scale=0.3)
        cand = normal(c, W2, D, scale=0.3)
        if name == "maxsim_int8":
            qw, qs = sk.project_queries_int8(q, w_rand)
            pool, aux = sk.pack_candidate_pool_int8(cand)
            return (qw, qs, pool, aux)
        return (sk.project_queries(q, w_rand), sk.pack_candidate_pool(cand))

    scorers = {"maxsim_bf16": (sk.bilinear_maxsim_scores,
                               sk.bilinear_maxsim_scores_plain),
               "maxsim_int8": (sk.bilinear_maxsim_scores_int8,
                               sk.bilinear_maxsim_scores_int8_plain)}
    for name, (kernel, plain) in scorers.items():
        rtol = sk.KERNEL_VS_PLAIN_RTOL[name]
        for nq in KERNEL_NQ:
            for c in KERNEL_POOLS:
                args = operands(name, nq, c)
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                torch.cuda.synchronize()
                if out.shape != (nq, c) or not torch.isfinite(out).all():
                    raise AssertionError(f"{name}: bad output {out.shape}")
                err = (out - ref).abs()
                row_max = ref.abs().amax(dim=1, keepdim=True)
                rel = float((err / row_max).max())
                max_err[name] = max(max_err[name], float(err.max()))
                log(f"check {name} nq={nq} C={c}: max_abs_err "
                    f"{float(err.max()):.3e}, max_rel_err {rel:.3e} "
                    f"(rtol {rtol:g} of the row's max |score|)")
                if rel > rtol:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version: {rel:.3e} > {rtol:g}")

    # --------------------------------------------------------------- engine
    cfg = MMSQAConfig(vocab_size=VOCAB)   # V4 at its published widths
    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        SEED), device=dev)
    # bench.py's random weights: the V4 init has W = 0, every score 0
    params["embed"]["w"] = normal(VOCAB, D, scale=0.3)
    params["sim"]["w"] = normal(M, D, D, scale=0.05)
    for name in state:  # positive running variance for the eval-mode BN
        state[name] = {"mean": normal(state[name]["mean"].shape[0], scale=0.1),
                       "var": torch.rand(state[name]["var"].shape,
                                         generator=gen, device=dev) + 0.5}
    cand_ids = torch.randint(0, VOCAB, (POOL, W2), generator=gen, device=dev)
    queries = torch.randint(0, VOCAB, (N_QUERIES, W1), generator=gen,
                            device=dev)
    q_rerank = queries[:N_RERANK]

    engines, results = {}, {}
    for pd in ("bf16", "int8"):
        t0 = time.perf_counter()
        engines[pd] = QueryEngine(params, cfg, pool_dtype=pd,
                                  device=dev).build_index(cand_ids)
        torch.cuda.synchronize()
        log(f"engine {pd}: built {POOL} candidates in "
            f"{time.perf_counter() - t0:.3f} s, pool "
            f"{engines[pd].pool.numel() * engines[pd].pool.element_size() / 2**30:.3f} GiB")

    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    for pd, eng in engines.items():            # the serving path, once
        vals, idx = eng.query(queries, k=K)
        rvals, ridx = eng.query_rerank(state, q_rerank, k=K,
                                       shortlist=SHORTLIST)
        torch.cuda.synchronize()
        results[pd] = (vals, idx, rvals, ridx)
    launches = dict(sk.LAUNCH_COUNTS)
    log(f"launches on the serving path: {launches}")
    for name in MAXSIM:
        if launches[name] < 1:
            raise AssertionError(f"the serving path never launched {name}")

    for pd, eng in engines.items():
        vals, idx, rvals, ridx = results[pd]
        if vals.shape != (N_QUERIES, K) or not torch.isfinite(vals).all():
            raise AssertionError(f"{pd}: bad query result {vals.shape}")
        if idx.min() < 0 or idx.max() >= POOL or (vals[:, :-1] < vals[:, 1:]).any():
            raise AssertionError(f"{pd}: indices out of range or unsorted")
        if rvals.shape != (N_RERANK, K) or not torch.isfinite(rvals).all() \
                or rvals.min() < 0 or rvals.max() > 1:
            raise AssertionError(f"{pd}: bad rerank probabilities")
        # brute force, plain version, on a few queries: the engine's top-k
        # must be the true top-k up to the kernel tolerance
        n_chk = 4
        rtol = sk.KERNEL_VS_PLAIN_RTOL["maxsim_" + pd]
        qt = eng.params["embed"]["w"][queries[:n_chk]] + eng.params["embed"]["b"]
        if pd == "int8":
            qw, qs = sk.project_queries_int8(qt, params["sim"]["w"])
            full = sk.bilinear_maxsim_scores_int8_plain(qw, qs, eng.pool,
                                                        eng.aux)
        else:
            full = sk.bilinear_maxsim_scores_plain(
                sk.project_queries(qt, params["sim"]["w"]), eng.pool)
        tol = rtol * full.abs().amax(dim=1, keepdim=True)
        got = torch.gather(full, 1, idx[:n_chk])
        if ((got - vals[:n_chk]).abs() > tol).any():
            raise AssertionError(f"{pd}: engine scores differ from plain")
        kth = full.topk(K, dim=1).values[:, -1:]
        if (got < kth - tol).any():
            raise AssertionError(f"{pd}: engine top-{K} is not the top-{K}")
        # the rerank returns members of the shortlist, scored by the model
        _, short = eng.query(q_rerank, k=SHORTLIST)
        if not (ridx[:, :, None] == short[:, None, :]).any(-1).all():
            raise AssertionError(f"{pd}: rerank left its shortlist")
        on_cpu = {"question": q_rerank.repeat_interleave(K, 0).cpu(),
                  "answer": eng.cand_token_ids[ridx.reshape(-1)].cpu(),
                  "overlap_feat": torch.zeros(N_RERANK * K,
                                              cfg.overlap_features)}
        out, _ = mms_qa_apply(tree_map(lambda t: t.cpu(), eng.params),
                              tree_map(lambda t: t.cpu(), state), on_cpu,
                              cfg, train=False)
        rr_err = float((out["prob"][:, 1].view(N_RERANK, K)
                        - rvals.cpu()).abs().max())
        if rr_err > PROB_ATOL:
            raise AssertionError(f"{pd}: rerank probs differ from the same "
                                 f"pairs scored on the CPU by {rr_err:.3e}")
        log(f"engine {pd}: {N_QUERIES} queries k={K} and rerank {N_RERANK} "
            f"x S={SHORTLIST} ok (rerank P vs CPU max abs diff {rr_err:.3e}, "
            f"tol {PROB_ATOL:g}); top-1 score "
            f"{float(vals[0, 0]):.4f}, top-1 rerank prob {float(rvals[0, 0]):.4f}")
    b_idx, i_idx = results["bf16"][1], results["int8"][1]
    agree = (i_idx[:, :, None] == b_idx[:, None, :]).any(-1).float().mean()
    log(f"int8 vs bf16 top-{K} agreement over {N_QUERIES} queries: "
        f"{float(agree):.4f}")

    # ------------------------------------------------------------- training
    train_launches = train_phase(dev, normal, card, max_err, timed)
    launches.update({k: train_launches[k] for k in KERNELS
                     if k not in MAXSIM})

    # ---------------------------------------------------------------- times
    for name, (kernel, plain) in scorers.items():
        args = operands(name, TIMED_NQ, TIMED_POOL)
        timed[name] = (event_ms(lambda: kernel(*args), 20),
                       event_ms(lambda: plain(*args), 5))
        log(f"time {name} {TIMED_NQ}q x {TIMED_POOL}: kernel "
            f"{timed[name][0]:.4f} ms, plain {timed[name][1]:.4f} ms "
            f"[{card}]")
    for pd, eng in engines.items():
        one = sync_ms(lambda: eng.query(queries[:1], k=K), 20)
        full = sync_ms(lambda: eng.query(queries, k=K), 5)
        rr = sync_ms(lambda: eng.query_rerank(state, q_rerank, k=K,
                                              shortlist=SHORTLIST), 10)
        qt = eng.params["embed"]["w"][queries] + eng.params["embed"]["b"]
        if pd == "int8":
            ops = (*sk.project_queries_int8(qt, params["sim"]["w"]),
                   eng.pool, eng.aux)
            scan = event_ms(lambda: sk.bilinear_maxsim_scores_int8(*ops), 5)
        else:
            ops = (sk.project_queries(qt, params["sim"]["w"]), eng.pool)
            scan = event_ms(lambda: sk.bilinear_maxsim_scores(*ops), 5)
        log(f"time engine {pd} at {POOL}: query 1q p50 {one:.3f} ms, "
            f"query {N_QUERIES}q p50 {full:.3f} ms "
            f"({N_QUERIES * POOL / full * 1e3:.4g} pairs/s; kernel alone "
            f"{scan:.3f} ms), query_rerank {N_RERANK}q S={SHORTLIST} p50 "
            f"{rr:.3f} ms [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timed[name][0], "plain_ms": timed[name][1]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
