#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port's two main paths (``mms_answer_selection_tpu_torch``) once
at the V4 recipe's widths, after building the hand-written kernels from
``mms_answer_selection_tpu_torch/csrc``:

* serving: holds the MaxSim kernels against their plain PyTorch versions
  (and the int4 kernel against the int8 kernel on the unpacked codes),
  builds a 262,144-candidate bf16, int8 and int4 ``QueryEngine`` over
  random weights made from a seed, answers 256 queries and a rerank on
  each, and checks the answers against a brute-force plain scoring, the
  rerank's probabilities against the same pairs scored on the CPU, and
  chunked against unchunked scoring; then the index lifecycle (remove,
  add, compact, save and load), the IVF index (probe-all against brute
  force, recall and latency at nprobe 1 and 8, the T=8 coarse shortlist),
  and the three dtypes at 1,048,576 candidates scored in chunks;
* training: holds the pair-map forward and backward kernels against their
  plain versions at V4 and V4_WIDE widths and at every batch size the
  main paths give them (and dW against itself, bit for bit), one train
  step on the card against the same step on the CPU, then ``Trainer.fit``
  on a synthetic corpus of the recipe's size (AdaDelta, batch 50, dev MAP
  every 100 steps), holding the best params' test-split probabilities
  against the CPU's and scoring them through ``trec_eval`` against the
  in-process MAP/MRR;
* V4_WIDE (D = 300) and long sentences: each MaxSim kernel against its
  plain version at D = 300 (rows past 256 bytes, the K-sliced plan) and
  at R = 800 query rows (W1 = 200, D = 50 and 300), a 262,144-candidate
  V4_WIDE engine of each dtype in turn, freed before the next, through
  the same checks as V4's, the pair-map kernels at (W1, W2) past 64 rows
  at D = 50 and 300, one V4_WIDE train step on the card against the CPU,
  and its step p50 at batch 50 and 1024;

and times the kernels, the engine and the train step.  The pair-map
kernels are timed at batch 50 and 1024 at D = 50 and at V4_WIDE's D = 300
(the forward also at the rerank's pairs), in turns with their einsums,
the MaxSim kernels at 16 queries x 8,192 candidates and at 1 and 256
queries x 262,144, each as a burst of launches between two CUDA events
with the host's enqueue kept off the clock; every kernel's time is printed
beside its bound (bytes over the HBM rate or operations over the peak,
whichever is larger).  After the build it counts, in the SASS of each
kernel, the Hopper tensor-core instructions (HGMMA, IGMMA), the legacy
ones (HMMA, IMMA) and the TMA loads (UTMALDG), and fails unless every
MaxSim kernel runs on wgmma alone.

Exits non-zero, before printing any result, when no CUDA device is present
or any phase fails.  The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists every kernel with its launches on the main path,
its error against the plain version, its time, the plain version's, the
bound and what sets it, and the one-call library time (null where no
single PyTorch call computes the function).  About 100-120 s on an
H100, build included, peaking near 27 GiB of device memory.
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
BIG_POOL, CHUNK = 1_048_576, 131_072   # the README's 1M pool, in chunks
LIFE_POOL, LIFE_CHUNK, LIFE_RESERVE = 20_000, 8192, 1000
# IVF: bench.py's topic pool and its ~2 clusters per latent topic
IVF_CLUSTERS, IVF_TOKENS, IVF_SHORTLIST, IVF_QUERIES = 1024, 8, 1024, 64
N_CHECK = 4                       # queries held against brute force
KERNEL_POOLS = (8192, 8192 + 37)  # one ragged: the last tile is partial
KERNEL_NQ = (1, 16, N_RERANK, N_QUERIES)  # latency, a batch, the main path
TIMED_NQ, TIMED_POOL = 16, 8192
SCAN_NQ = (1, N_QUERIES)          # MaxSim also timed at these x POOL
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "UTMALDG")
FIT_STEPS, TEST_INTERVAL, BATCH = 301, 100, 50
# training: (N, D) pair-map checks at W1 = W2 = 40, M = 4: V4 at batch 50
# and 1024, ragged batches, the rerank's Nq x S pairs, V4_WIDE's D = 300,
# and D not a multiple of 4 on either side of a 32 boundary (the dev and
# test split sizes, which the evals give the kernel, join them once the
# corpus is made); the recipe-sized synthetic corpus
PAIR_CHECKS = ((BATCH, D), (7, D), (1, D), (1024, D),
               (N_RERANK * SHORTLIST, D), (BATCH, 300), (BATCH, 33),
               (BATCH, 301))
# pair-map times: the recipe's batch, batch 1024, V4_WIDE; the forward also
# at the rerank's Nq x S pairs.  The kernels line reports the first.
PAIR_TIMED = ((BATCH, D), (1024, D), (BATCH, 300), (1024, 300))
FWD_TIMED = ((N_RERANK * SHORTLIST, D),)
TRAIN_Q, DEV_Q, TEST_Q = 1250, 65, 68
# V4_WIDE (GloVe-300d) at full width: its MaxSim rows are 608 / 320 bytes,
# past the resident plan (K-sliced); R = 800 query rows (W1 = 200) at D =
# 50 and 300; pair maps at long sentences, (W1, W2) past 64 rows, dW
# bit-identical twice at each
WIDE_D = 300
R800_W1 = 200
LONG_PAIRS = ((100, 100), (65, 40), (40, 100), (200, 64))
WIDE_STEP_BATCHES = (BATCH, 1024)
# |P(correct)| card vs CPU on the same weights and pairs: float32 on both,
# only the summation order of the pair maps, convs and MLP differs
PROB_ATOL = 1e-4
STEP_BATCHES = (50, 256, 1024)
ADADELTA_STEP = (5e-7 / 0.05) ** 0.5   # lr * sqrt(delta / (1 - momentum))

# the H100 SXM's published peaks (NVIDIA data sheet, dense): bytes/s of
# HBM3, and operations/s by operand type.  The pair maps' products must be
# float32-accurate; the card's fastest way to that is 3xTF32 on the tensor
# cores (three TF32 products per float32 one, the forward's design), 495 /
# 3 = 165 TFLOP/s, above the 67 TFLOP/s of float32 FMAs, so their bound
# counts every product at that rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"3xtf32": 495e12 / 3, "bf16": 989e12, "int8": 1979e12}
BOUND_TYPE = {"maxsim_bf16": "bf16", "maxsim_int8": "int8",
              "maxsim_int4": "int8", "pair_maps_fwd": "3xtf32",
              "pair_maps_bwd_qa": "3xtf32", "pair_maps_bwd_w": "3xtf32"}

ROOT = Path(__file__).resolve().parent
CSRC = "mms_answer_selection_tpu_torch/csrc/"
PALLAS = "mms_answer_selection_tpu/ops/sim_cross_pallas.py:"
KERNELS = {  # kernel -> (source, the TPU kernel it replaces)
    "maxsim_bf16": (CSRC + "maxsim_bf16.cu", PALLAS + "190"),
    "maxsim_int8": (CSRC + "maxsim_int8.cu", PALLAS + "534"),
    "maxsim_int4": (CSRC + "maxsim_int8.cu", PALLAS + "799"),
    "pair_maps_fwd": (CSRC + "pair_maps.cu", PALLAS + "85"),
    "pair_maps_bwd_qa": (CSRC + "pair_maps.cu", PALLAS + "156"),
    "pair_maps_bwd_w": (CSRC + "pair_maps.cu", PALLAS + "156"),
}
MAXSIM = ("maxsim_bf16", "maxsim_int8", "maxsim_int4")
POOL_DTYPES = ("bf16", "int8", "int4")


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


def burst_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls enqueued
    back to back behind a sleeping kernel, so the host's enqueue stays off
    the clock, between two CUDA events, divided by ``reps`` (warm)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sass_counts(so: Path) -> dict:
    """Per kernel of the built library (mangled name), the count of each of
    SASS_OPS in its SASS, from the ``cuobjdump`` beside the ``nvcc`` that
    built it."""
    import os
    import re

    from mms_answer_selection_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and op and op.group(1) in SASS_OPS:
            counts[name][op.group(1)] += 1
    return counts


def bound_ms(name: str, ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak for the kernel's operand
    type; and which of the two it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[BOUND_TYPE[name]] * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def pair_bound(name: str, n: int, d: int) -> tuple[float, str]:
    """``bound_ms`` of a pair-map kernel at W1 = W2 = 40, M = 4: 2 N M W1
    D (D + W2) operations (twice that for dQ and dA together), each input
    read and each output written once."""
    ops = 2 * n * M * W1 * d * (d + W2) * (2 if name == "pair_maps_bwd_qa"
                                            else 1)
    q, a, w, g = n * W1 * d, n * W2 * d, M * d * d, n * W1 * W2 * M
    floats = {"pair_maps_fwd": q + a + w + g,
              "pair_maps_bwd_w": q + a + g + w,
              "pair_maps_bwd_qa": q + a + w + g + q + a}[name]
    return bound_ms(name, ops, 4 * floats)


def maxsim_bound(name: str, args, out_bytes: int,
                 d: int = D) -> tuple[float, str]:
    """``bound_ms`` of a MaxSim kernel: 2 x (Nq M W1) x C x W2 x D
    operations (the unpadded widths), the operands as given read once and
    the scores written once."""
    nq, c = args[0].shape[0], args[2 if len(args) > 2 else 1].shape[0]
    ops = 2 * nq * M * W1 * c * W2 * d
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    return bound_ms(name, ops, nbytes)


def recipe_corpus(dim: int):
    """The recipe-sized synthetic TREC-QA corpus (50,093 / 1,195 / 1,569
    pairs) with embeddings of ``dim`` lanes: (splits, vocab info, host
    prep seconds)."""
    from mms_answer_selection_tpu_torch.data import (
        prepare_trec_qa, synthetic_split, synthetic_world)

    t0 = time.perf_counter()
    world = synthetic_world(vocab_words=22500, n_topics=250, dim=dim, seed=22)
    splits, info = prepare_trec_qa(
        synthetic_split(world, TRAIN_Q, 30, 50, seed=101),
        synthetic_split(world, DEV_Q, 12, 24, seed=202),
        synthetic_split(world, TEST_Q, 15, 29, seed=303), world["w2v"])
    prep_s = time.perf_counter() - t0
    log(f"data (D={dim}): {({k: len(v['label']) for k, v in splits.items()})}"
        f" pairs, vocab {info['vocab_size']}, host prep {prep_s:.3f} s")
    return splits, info, prep_s


def recipe_trainer():
    """The recipe's solver and schedule: AdaDelta, batch 50, dev MAP every
    100 steps."""
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, TrainerConfig)

    recipe = SolverConfig(solver_type="adadelta", base_lr=1.0, momentum=0.95,
                          delta=5e-7, weight_decay=5e-4)
    return TrainerConfig(solver=recipe, max_iter=FIT_STEPS, batch_size=BATCH,
                         test_interval=TEST_INTERVAL, seed=22)


def pair_operands(normal, n: int, d: int, w1: int = W1, w2: int = W2):
    """q, a, W and dL/dout of a pair-map call at M = 4."""
    return (normal(n, w1, d, scale=0.3), normal(n, w2, d, scale=0.3),
            normal(M, d, d, scale=0.05), normal(n, w1, w2, M))


def pair_kernels(sk) -> dict:
    """kernel -> (wrapper, plain version), each taking (q, a, W, G) and
    giving a list of outputs."""
    grads_plain = sk.bilinear_pair_maps_grads_plain
    return {
        "pair_maps_fwd": (lambda q, a, w, g: [sk.pair_maps_fwd(q, a, w)],
                          lambda q, a, w, g: [
                              sk.bilinear_pair_maps_plain(q, a, w)]),
        "pair_maps_bwd_qa": (lambda *o: list(sk.pair_maps_bwd_qa(*o)),
                             lambda *o: list(grads_plain(
                                 *o, need_w=False)[:2])),
        "pair_maps_bwd_w": (lambda *o: [sk.pair_maps_bwd_w(*o)],
                            lambda *o: [grads_plain(*o, need_qa=False)[2]]),
    }


def check_pair_kernels(sk, pairs: dict, ops, max_err: dict) -> None:
    """Each pair-map kernel against its plain version on ``ops``, within
    ``KERNEL_VS_PLAIN_RTOL`` of the output's max |value|, and dW twice,
    bit for bit."""
    n, w1, d = ops[0].shape
    w2 = ops[1].shape[1]
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
            log(f"check {name} N={n} W1={w1} W2={w2} D={d} out "
                f"{tuple(x.shape)}: max_abs_err {err:.3e}, max_rel_err "
                f"{rel:.3e} (rtol {rtol:g} of the output's max |value|)")
            if rel > rtol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rel:.3e} > {rtol:g}")
    if not torch.equal(sk.pair_maps_bwd_w(*ops), sk.pair_maps_bwd_w(*ops)):
        raise AssertionError(f"pair_maps_bwd_w: dW differs between two runs "
                             f"at N={n} W1={w1} W2={w2} D={d}")


def step_card_vs_cpu(model, tcfg, splits, info, dev, label: str) -> None:
    """One train step on the card against the same step on the CPU.
    Xavier W and no dropout: a well-conditioned step that both devices
    compute without randomness.  Loss within 1e-5 relative; every param
    within rtol 1e-4 + atol 1e-5, except the conv biases: each feeds a
    train-mode BN, so its true gradient is 0 and each device moves it by
    AdaDelta's normalized step (at most lr_mult 2 x ADADELTA_STEP) in a
    direction set by rounding noise."""
    import dataclasses

    from mms_answer_selection_tpu_torch.training import Trainer
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

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
                raise AssertionError(f"train step {label}: {name}.{k} differs "
                                     f"between card and CPU by {diff:.3e}")
    log(f"check train step card vs CPU ({label}, batch {BATCH}, xavier W, "
        f"no dropout): loss {float(gpu['loss']):.6f}, rel err "
        f"{loss_rel:.3e} (tol 1e-5); params max abs diff {worst:.3e} (rtol "
        f"1e-4, atol 1e-5; conv biases within {band:.3e})")
    if loss_rel > 1e-5:
        raise AssertionError(f"train step {label}: loss differs between card"
                             f" and CPU")


def step_times(model, tcfg, splits, info, dev, batches, label: str,
               card: str) -> None:
    """Train step p50 on the corpus's first epoch batch of each size."""
    import dataclasses

    from mms_answer_selection_tpu_torch.training import Trainer

    for b in batches:
        tr = Trainer(model, dataclasses.replace(tcfg, batch_size=b),
                     device=dev)
        p, s, o = tr.init(pretrained=info["pretrained"])
        train = tr._full_batch({k: v for k, v in splits["train"].items()
                                if k != "group"})
        batch = next(tr._epoch_batches(train, 0))
        ms = sync_ms(lambda: tr._train_step(p, s, o, batch, 0),
                     max(5, 2000 // b))
        log(f"time train step {label} batch {b}: p50 {ms:.3f} ms, "
            f"{1e3 / ms:.2f} steps/s, {b * 1e3 / ms:.0f} pairs/s [{card}]")


def train_phase(dev, normal, card: str, max_err: dict, timed: dict) -> dict:
    """The training path: pair-map kernels against their plain versions,
    one train step on the card against the CPU, ``fit`` on the recipe-sized
    synthetic corpus with the ``trec_eval`` cross-check, and the times.
    Fills ``max_err`` and ``timed`` for the pair-map kernels and returns
    the launch counts of the ``fit`` run."""
    import dataclasses
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch.metrics import (
        mean_average_precision, mean_reciprocal_rank, trec_eval,
        write_trec_files)
    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.training import Trainer
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    splits, info, prep_s = recipe_corpus(D)

    # ------------------------------------- pair-map kernels vs plain
    pairs = pair_kernels(sk)
    sizes = (len(splits["dev"]["label"]), len(splits["test"]["label"]))
    for n, d in PAIR_CHECKS + tuple((n, D) for n in sizes):
        check_pair_kernels(sk, pairs, pair_operands(normal, n, d), max_err)
    log("check pair_maps_bwd_w: dW bit-identical across two runs at every "
        "shape")

    tcfg = recipe_trainer()
    model = dataclasses.replace(V4, vocab_size=info["vocab_size"])
    step_card_vs_cpu(model, tcfg, splits, info, dev, "V4")

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
    # In turns: plain, kernel, kernel, plain.  The plain versions of the
    # forward and dW are single torch.einsum calls (cuBLAS float32), so
    # they are also the library time; dQ and dA take two einsums, and no
    # single call computes both.
    for n, d in PAIR_TIMED + FWD_TIMED:
        ops = pair_operands(normal, n, d)
        names = pairs if (n, d) in PAIR_TIMED else ("pair_maps_fwd",)
        for name in names:
            kernel, plain = pairs[name]
            t = [burst_ms(lambda: plain(*ops), 30),
                 burst_ms(lambda: kernel(*ops), 100),
                 burst_ms(lambda: kernel(*ops), 100),
                 burst_ms(lambda: plain(*ops), 30)]
            k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            lib_ms = None if name == "pair_maps_bwd_qa" else p_ms
            b_ms, b_by = pair_bound(name, n, d)
            if (n, d) == (BATCH, D):
                timed[name] = (k_ms, p_ms, lib_ms, b_ms, b_by)
            log(f"time {name} at N={n}, W1=W2={W1}, D={d}, M={M}: kernel "
                f"{k_ms:.4f} ms, "
                f"{'einsum' if lib_ms else 'plain (2 einsums)'} {p_ms:.4f} ms ({p_ms / k_ms:.2f}x), bound {b_ms:.4f} ms "
                f"({b_by}; {b_ms / k_ms:.1%} of it reached) "
                f"[{[round(x, 4) for x in t]}; {card}]")
    step_times(model, tcfg, splits, info, dev, STEP_BATCHES, "V4", card)
    log(f"time fit {FIT_STEPS} steps at batch {BATCH} with "
        f"{len(hist['steps'])} dev+test evals: {fit_s:.3f} s "
        f"({FIT_STEPS / fit_s:.2f} steps/s); host data prep {prep_s:.3f} s "
        f"[{card}]")
    return launches


def wide_train_phase(dev, normal, card: str, max_err: dict) -> None:
    """Long sentences and V4_WIDE's training: the pair-map kernels against
    their plain versions at (W1, W2) past 64 rows, at D = 50 and 300 (dW
    bit-identical twice at each), one V4_WIDE train step on the card
    against the CPU, and its step p50 at batch 50 and 1024 on corpus
    batches."""
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4_WIDE
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    pairs = pair_kernels(sk)
    for w1, w2 in LONG_PAIRS:
        for d in (D, WIDE_D):
            check_pair_kernels(sk, pairs, pair_operands(normal, BATCH, d, w1,
                                                        w2), max_err)
    log(f"check long sentences (W1, W2) {LONG_PAIRS} at D = {D} and "
        f"{WIDE_D}: every pair-map kernel matches plain, dW bit-identical "
        f"across two runs at each")
    splits, info, _ = recipe_corpus(WIDE_D)
    tcfg = recipe_trainer()
    model = dataclasses.replace(V4_WIDE, vocab_size=info["vocab_size"])
    step_card_vs_cpu(model, tcfg, splits, info, dev, "V4_WIDE")
    step_times(model, tcfg, splits, info, dev, WIDE_STEP_BATCHES, "V4_WIDE",
               card)


def plain_scores(eng, query_ids):
    """(Nq, C) scores of the engine's pool by the plain PyTorch versions,
    one chunk at a time."""
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    plain = {"bf16": sk.bilinear_maxsim_scores_plain,
             "int8": sk.bilinear_maxsim_scores_int8_plain,
             "int4": sk.bilinear_maxsim_scores_int4_plain}[eng.pool_dtype]
    proj = eng.project(eng.query_tokens(query_ids))
    out = []
    for a in range(0, eng.pool_size, eng.chunk_size):
        b = min(eng.pool_size, a + eng.chunk_size)
        aux = () if eng.aux is None else (eng.aux[a:b],)
        out.append(plain(*proj, eng.pool[a:b], *aux))
    return torch.cat(out, 1)


def check_topk(eng, query_ids, vals, idx, what: str) -> None:
    """The engine's top-k on a few queries must be the brute-force plain
    top-k, up to the kernel's tolerance."""
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    full = plain_scores(eng, query_ids)
    tol = sk.KERNEL_VS_PLAIN_RTOL["maxsim_" + eng.pool_dtype] \
        * full.abs().amax(dim=1, keepdim=True)
    got = torch.gather(full, 1, idx)
    if ((got - vals).abs() > tol).any():
        raise AssertionError(f"{what}: engine scores differ from plain")
    kth = full.topk(idx.shape[1], dim=1).values[:, -1:]
    if (got < kth - tol).any():
        raise AssertionError(f"{what}: engine top-{idx.shape[1]} is not the "
                             f"top-{idx.shape[1]}")


def same_topk(got, want) -> bool:
    """Equal scores, and equal indices wherever a score is not tied with a
    neighbour (among tied scores the scan order decides)."""
    (gv, gi), (wv, wi) = [(v.cpu(), i.cpu()) for v, i in (got, want)]
    if not torch.equal(gv, wv):
        return False
    tied = torch.zeros_like(wv, dtype=torch.bool)
    tied[:, 1:] |= wv[:, 1:] == wv[:, :-1]
    tied[:, :-1] |= wv[:, :-1] == wv[:, 1:]
    return torch.equal(gi[~tied], wi[~tied])


def gib(eng) -> float:
    return sum(t.numel() * t.element_size() for t in (eng.pool, eng.aux)
               if t is not None) / 2**30


def scorer_args(sk, name: str, q, cand, w) -> tuple:
    """A MaxSim kernel's operands for query tokens q, candidate tokens cand
    and the metric w."""
    if name == "maxsim_int8":
        return (*sk.project_queries_int8(q, w),
                *sk.pack_candidate_pool_int8(cand))
    if name == "maxsim_int4":
        return (*sk.project_queries_int4(q, w),
                *sk.pack_candidate_pool_int4(cand))
    return (sk.project_queries(q, w), sk.pack_candidate_pool(cand))


def maxsim_scorers(sk) -> dict:
    """MaxSim kernel -> (wrapper, plain version)."""
    return {"maxsim_bf16": (sk.bilinear_maxsim_scores,
                            sk.bilinear_maxsim_scores_plain),
            "maxsim_int8": (sk.bilinear_maxsim_scores_int8,
                            sk.bilinear_maxsim_scores_int8_plain),
            "maxsim_int4": (sk.bilinear_maxsim_scores_int4,
                            sk.bilinear_maxsim_scores_int4_plain)}


def check_maxsim(sk, name: str, args, label: str, max_err: dict) -> None:
    """A MaxSim kernel against its plain version on ``args``, within
    ``KERNEL_VS_PLAIN_RTOL`` of the row's max |score|; ``maxsim_int4``
    also bit for bit against ``maxsim_int8`` on the unpacked codes."""
    kernel, plain = maxsim_scorers(sk)[name]
    nq, c = args[0].shape[0], args[2 if len(args) > 2 else 1].shape[0]
    rtol = sk.KERNEL_VS_PLAIN_RTOL[name]
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    if out.shape != (nq, c) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad output {out.shape}")
    err = (out - ref).abs()
    rel = float((err / ref.abs().amax(dim=1, keepdim=True)).max())
    max_err[name] = max(max_err[name], float(err.max()))
    same = ""
    if name == "maxsim_int4":
        qw, qs, pool, aux = args
        if not torch.equal(out, sk.bilinear_maxsim_scores_int8(
                qw, qs, sk.unpack_int4(pool), aux)):
            raise AssertionError(f"maxsim_int4 differs from maxsim_int8 on "
                                 f"the unpacked codes ({label})")
        same = "; bit-identical to maxsim_int8 on the unpacked codes"
    log(f"check {name} {label} Dp={args[0].shape[2]}: max_abs_err "
        f"{float(err.max()):.3e}, max_rel_err {rel:.3e} (rtol {rtol:g} of "
        f"the row's max |score|){same}")
    if rel > rtol:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label}): {rel:.3e} > {rtol:g}")


def check_engine(eng, cfg, state, queries, result, label: str) -> None:
    """The serving path's answers: the 256-query top-k sorted and equal to
    brute force on N_CHECK queries, chunked = unchunked bit for bit, the
    rerank inside its shortlist with probabilities within PROB_ATOL of the
    same pairs on the CPU."""
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_apply
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    vals, idx, rvals, ridx = result
    q_rerank = queries[:N_RERANK]
    if vals.shape != (N_QUERIES, K) or not torch.isfinite(vals).all():
        raise AssertionError(f"{label}: bad query result {vals.shape}")
    if idx.min() < 0 or idx.max() >= eng.pool_size \
            or (vals[:, :-1] < vals[:, 1:]).any():
        raise AssertionError(f"{label}: indices out of range or unsorted")
    if rvals.shape != (N_RERANK, K) or not torch.isfinite(rvals).all() \
            or rvals.min() < 0 or rvals.max() > 1:
        raise AssertionError(f"{label}: bad rerank probabilities")
    check_topk(eng, queries[:N_CHECK], vals[:N_CHECK], idx[:N_CHECK], label)
    # chunked scoring gives the unchunked scores and order, bit for bit
    chunk, eng.chunk_size = eng.chunk_size, eng.pool_size
    flat = eng.query(queries, k=K)
    eng.chunk_size = chunk
    if not (torch.equal(flat[0], vals) and torch.equal(flat[1], idx)):
        raise AssertionError(f"{label}: chunked top-{K} differs from "
                             f"unchunked")
    # the rerank returns members of the shortlist, scored by the model
    _, short = eng.query(q_rerank, k=SHORTLIST)
    if not (ridx[:, :, None] == short[:, None, :]).any(-1).all():
        raise AssertionError(f"{label}: rerank left its shortlist")
    on_cpu = {"question": q_rerank.repeat_interleave(K, 0).cpu(),
              "answer": eng.cand_token_ids[ridx.reshape(-1)].cpu(),
              "overlap_feat": torch.zeros(N_RERANK * K,
                                          cfg.overlap_features)}
    out, _ = mms_qa_apply(tree_map(lambda t: t.cpu(), eng.params),
                          tree_map(lambda t: t.cpu(), state), on_cpu, cfg,
                          train=False)
    rr_err = float((out["prob"][:, 1].view(N_RERANK, K)
                    - rvals.cpu()).abs().max())
    if rr_err > PROB_ATOL:
        raise AssertionError(f"{label}: rerank probs differ from the same "
                             f"pairs scored on the CPU by {rr_err:.3e}")
    log(f"engine {label}: {N_QUERIES} queries k={K} and rerank {N_RERANK} x "
        f"S={SHORTLIST} ok (top-{K} = brute force on {N_CHECK} queries; "
        f"chunked = unchunked; rerank P vs CPU max abs diff {rr_err:.3e}, "
        f"tol {PROB_ATOL:g}); top-1 score {float(vals[0, 0]):.4f}, top-1 "
        f"rerank prob {float(rvals[0, 0]):.4f}")


def random_model(cfg, normal, gen, dev):
    """bench.py's random weights for ``cfg`` (the recipe's init has W = 0,
    every score 0) and a positive running variance for the eval-mode BN."""
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_init

    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        SEED), device=dev)
    d = cfg.embed_dim
    params["embed"]["w"] = normal(cfg.vocab_size, d, scale=0.3)
    params["sim"]["w"] = normal(M, d, d, scale=0.05)
    for name in state:
        state[name] = {"mean": normal(state[name]["mean"].shape[0], scale=0.1),
                       "var": torch.rand(state[name]["var"].shape,
                                         generator=gen, device=dev) + 0.5}
    return params, state


def wide_serving_phase(sk, normal, gen, dev, card: str,
                       max_err: dict) -> None:
    """V4_WIDE's serving at full width (D = 300: bf16 rows of 608 bytes,
    int8 of 320, K-sliced): each MaxSim kernel against its plain version
    at KERNEL_NQ x KERNEL_POOLS, at R = 800 query rows (D = 50 and 300),
    then a POOL-candidate engine of each dtype in chunks of CHUNK, one at
    a time, through ``check_engine``, with p50 times and the kernel's time
    beside its bound."""
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4_WIDE
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    w = normal(M, WIDE_D, WIDE_D, scale=0.05)
    for name in MAXSIM:
        for nq in KERNEL_NQ:
            for c in KERNEL_POOLS:
                args = scorer_args(sk, name, normal(nq, W1, WIDE_D, scale=0.3),
                                   normal(c, W2, WIDE_D, scale=0.3), w)
                check_maxsim(sk, name, args, f"V4_WIDE nq={nq} C={c}",
                             max_err)
    for d in (D, WIDE_D):
        w_d = normal(M, d, d, scale=0.05)
        for name in MAXSIM:
            args = scorer_args(sk, name, normal(4, R800_W1, d, scale=0.3),
                               normal(KERNEL_POOLS[1], W2, d, scale=0.3), w_d)
            check_maxsim(sk, name, args, f"R={M * R800_W1} D={d} "
                         f"C={KERNEL_POOLS[1]}", max_err)

    cfg = dataclasses.replace(V4_WIDE, vocab_size=VOCAB)
    params, state = random_model(cfg, normal, gen, dev)
    cand_ids = torch.randint(0, VOCAB, (POOL, W2), generator=gen, device=dev)
    queries = torch.randint(0, VOCAB, (N_QUERIES, W1), generator=gen,
                            device=dev)
    for pd in POOL_DTYPES:
        t0 = time.perf_counter()
        eng = QueryEngine(params, cfg, pool_dtype=pd, chunk_size=CHUNK,
                          device=dev).build_index(cand_ids)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        name = "maxsim_" + pd
        for k in sk.LAUNCH_COUNTS:
            sk.LAUNCH_COUNTS[k] = 0
        result = (*eng.query(queries, k=K),
                  *eng.query_rerank(state, queries[:N_RERANK], k=K,
                                    shortlist=SHORTLIST))
        torch.cuda.synchronize()
        launches = sk.LAUNCH_COUNTS[name]
        if launches < 1:
            raise AssertionError(f"V4_WIDE {pd}: the serving path never "
                                 f"launched {name}")
        check_engine(eng, cfg, state, queries, result, f"V4_WIDE {pd}")
        one = sync_ms(lambda: eng.query(queries[:1], k=K), 10)
        full = sync_ms(lambda: eng.query(queries, k=K), 3)
        rr = sync_ms(lambda: eng.query_rerank(
            state, queries[:N_RERANK], k=K, shortlist=SHORTLIST), 5)
        ops = (*eng.project(eng.query_tokens(queries)), eng.pool) \
            + (() if eng.aux is None else (eng.aux,))
        scan = burst_ms(lambda: maxsim_scorers(sk)[name][0](*ops), 2)
        b_ms, b_by = maxsim_bound(name, ops, N_QUERIES * POOL * 4, WIDE_D)
        geo = sk.maxsim_geometry(N_QUERIES, M * W1, POOL, eng.pool.shape[1],
                                 ops[0].shape[2], pd)
        log(f"time engine V4_WIDE {pd} at {POOL} (chunks of {CHUNK}; built "
            f"in {build_s:.3f} s, pool {gib(eng):.3f} GiB, {launches} "
            f"launches of {name} on the path, K-sliced {geo.k_sliced}): query"
            f" 1q p50 {one:.3f} ms, query {N_QUERIES}q p50 {full:.3f} ms "
            f"({N_QUERIES * POOL / full * 1e3:.4g} pairs/s; kernel alone, "
            f"unchunked, {scan:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
            f"{b_ms / scan:.1%} of it reached)), query_rerank {N_RERANK}q "
            f"S={SHORTLIST} p50 {rr:.3f} ms [{card}]")
        del eng, ops, result
        torch.cuda.empty_cache()


def lifecycle_phase(params, state, cfg, cand_ids, queries, dev) -> None:
    """Remove, add, compact, save and load on the card, for each dtype,
    on a pool of LIFE_POOL candidates scored in chunks of LIFE_CHUNK."""
    import tempfile

    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    q = queries[:8]
    for pd in POOL_DTYPES:
        eng = QueryEngine(params, cfg, pool_dtype=pd, chunk_size=LIFE_CHUNK,
                          device=dev).build_index(cand_ids[:LIFE_POOL],
                                                  reserve=LIFE_RESERVE)
        _, top = eng.query(q, k=K)
        dead = sorted(set(top[:, :3].flatten().tolist()) | {0, LIFE_POOL - 1})
        eng.remove_candidates(dead)
        vals, idx = eng.query(q, k=K)
        _, ridx = eng.query_rerank(state, q, k=K, shortlist=SHORTLIST)
        if set(idx.flatten().tolist()) & set(dead) \
                or set(ridx.flatten().tolist()) & set(dead):
            raise AssertionError(f"lifecycle {pd}: a removed row came back")
        check_topk(eng, q, vals, idx, f"lifecycle {pd} after remove")
        # added rows are found: a copy of each query's best live hit, past
        # the reserve (so the pool grows), is in the top-K with its
        # original's score
        best = idx[:, 0]
        extra = cand_ids[LIFE_POOL:LIFE_POOL + LIFE_RESERVE + 10]
        new = eng.add_candidates(torch.cat([extra, cand_ids[best]]))
        copies = new[-len(best):]
        vals2, idx2 = eng.query(q, k=K)
        tol = sk.KERNEL_VS_PLAIN_RTOL["maxsim_" + pd] * vals2.abs().amax()
        for i, row in enumerate(idx2.tolist()):
            if int(best[i]) not in row or int(copies[i]) not in row \
                    or abs(vals2[i, row.index(int(copies[i]))]
                           - vals2[i, row.index(int(best[i]))]) > tol:
                raise AssertionError(f"lifecycle {pd}: an added row was not "
                                     f"found")
        check_topk(eng, q, vals2, idx2, f"lifecycle {pd} after add")
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "index.npz")
            eng.save_index(path)
            other = QueryEngine(params, cfg, pool_dtype=pd,
                                chunk_size=LIFE_CHUNK, device=dev)
            other.load_index(path)
        loaded = other.query(q, k=K)
        if not (torch.equal(loaded[0], vals2) and torch.equal(loaded[1], idx2)):
            raise AssertionError(f"lifecycle {pd}: a reloaded index answers "
                                 f"differently")
        n_before = eng.pool_size
        mapping = eng.compact()
        after = eng.query(q, k=K)
        keep = torch.ones(n_before, dtype=torch.bool)
        keep[dead] = False
        if not (torch.equal(mapping[keep], torch.arange(int(keep.sum())))
                and (mapping[dead] == -1).all()
                and same_topk(after, (vals2, mapping[idx2.cpu()]))):
            raise AssertionError(f"lifecycle {pd}: compact's map is wrong")
        log(f"lifecycle {pd} at {LIFE_POOL} (+{LIFE_RESERVE} reserve, chunk "
            f"{LIFE_CHUNK}): {len(dead)} removed never returned (query and "
            f"rerank), {len(new)} added ({len(best)} copies found at the "
            f"top), save/load equal, compact {n_before} -> {eng.pool_size} "
            f"map ok")


def topic_pool(params, gen, dev):
    """bench.py's IVF regime, a trained-model proxy: 512 latent topics,
    each vocabulary slice's embeddings a topic center plus token noise, W
    identity-dominant plus noise, each candidate's tokens from one topic,
    each query's from two (interleaved).  (Under the random weights of the
    other phases no router beats the probed fraction.)  Returns the
    params, POOL candidate ids and IVF_QUERIES query ids."""
    n_topics = 512
    slice_w = VOCAB // n_topics

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    v_topic = (torch.arange(VOCAB, device=dev) // slice_w).clamp(
        max=n_topics - 1)
    centers = rand(n_topics, D)
    topical = {"embed": {**params["embed"], "w": 0.3 * (
                   0.6 * centers[v_topic] + 0.8 * rand(VOCAB, D))},
               "sim": {**params["sim"], "w": 0.2 * torch.eye(D, device=dev)
                       + rand(M, D, D) * 0.05}}
    topical = {**params, **topical}
    cand = ints(n_topics, POOL)[:, None] * slice_w + ints(slice_w, POOL, W2)
    q_mix = ints(n_topics, IVF_QUERIES, 2)[:, torch.arange(W1) % 2]
    queries = q_mix * slice_w + ints(slice_w, IVF_QUERIES, W1)
    return topical, cand, queries


def ivf_phase(params, cfg, gen, dev, card: str) -> None:
    """IVF over a topic-structured POOL of bf16 and of int8 (``topic_pool``):
    build, probe-all against brute force, recall@10 and 1-query p50 at
    nprobe 1 and 8, and the T=8 coarse shortlist; the path must launch
    both kernels."""
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.serve import QueryEngine
    from mms_answer_selection_tpu_torch.serve.ivf import ivf_recall

    topical, cand, q = topic_pool(params, gen, dev)
    engines = {pd: QueryEngine(topical, cfg, pool_dtype=pd, chunk_size=CHUNK,
                               device=dev).build_index(cand)
               for pd in ("bf16", "int8")}
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    results = {}
    for pd, eng in engines.items():            # the IVF path, once
        t0 = time.perf_counter()
        ivf = eng.build_ivf(n_clusters=IVF_CLUSTERS, seed=SEED,
                            coarse_tokens=IVF_TOKENS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        results[pd] = (build_s, eng.query(q[:N_CHECK], k=K),
                       eng.query_ivf(q[:N_CHECK], k=K, nprobe=IVF_CLUSTERS),
                       ivf.query_coarse(q, k=K, shortlist=IVF_SHORTLIST))
        torch.cuda.synchronize()
    launches = dict(sk.LAUNCH_COUNTS)
    log(f"launches on the IVF path: {launches}")
    for name in ("maxsim_bf16", "maxsim_int8"):
        if launches[name] < 1:
            raise AssertionError(f"the IVF path never launched {name}")
    for pd, (build_s, brute, probe_all, coarse) in results.items():
        eng, ivf = engines[pd], engines[pd].ivf
        if not same_topk(probe_all, brute):
            raise AssertionError(f"IVF {pd}: probe-all differs from brute "
                                 f"force")
        if coarse[0].shape != (IVF_QUERIES, K) \
                or not torch.isfinite(coarse[0]).all():
            raise AssertionError(f"IVF {pd}: bad coarse result")
        _, brute_idx = eng.query(q, k=K)
        brute_ms = sync_ms(lambda: eng.query(q[:1], k=K), 20)
        line = []
        for nprobe in (1, 8):
            rec = ivf_recall(eng, q, k=K, nprobe=nprobe, brute_idx=brute_idx)
            ms = sync_ms(lambda: eng.query_ivf(q[:1], k=K, nprobe=nprobe), 20)
            line.append(f"nprobe {nprobe}: recall@{K} {rec:.4f}, 1q p50 "
                        f"{ms:.3f} ms")
        rec = ivf_recall(eng, q, k=K, method="coarse",
                         shortlist=IVF_SHORTLIST, brute_idx=brute_idx)
        ms = sync_ms(lambda: ivf.query_coarse(q[:1], k=K,
                                              shortlist=IVF_SHORTLIST), 20)
        log(f"IVF {pd} at {eng.pool_size} (topic pool): {ivf.n_clusters} "
            f"clusters, bucket {ivf.bucket}, spilled {ivf.spilled}, built in "
            f"{build_s:.3f} s (T={IVF_TOKENS} mini pool included); probe-all "
            f"= brute force on {N_CHECK} queries; brute force 1q p50 "
            f"{brute_ms:.3f} ms; " + "; ".join(line) + f"; coarse T="
            f"{IVF_TOKENS} S={IVF_SHORTLIST}: recall@{K} {rec:.4f}, 1q p50 "
            f"{ms:.3f} ms (recall over {IVF_QUERIES} queries) [{card}]")


def scale_phase(params, state, cfg, queries, gen, dev, card: str) -> None:
    """Each dtype at BIG_POOL candidates scored in chunks of CHUNK: build
    time, pool size, brute-force check, query p50 at 256 and 1 queries,
    and the int4 rerank p50."""
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    cand = torch.randint(0, VOCAB, (BIG_POOL, W2), generator=gen, device=dev)
    q_rerank = queries[:N_RERANK]
    for pd in ("int8", "int4", "bf16"):
        t0 = time.perf_counter()
        eng = QueryEngine(params, cfg, pool_dtype=pd, chunk_size=CHUNK,
                          device=dev).build_index(cand)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        vals, idx = eng.query(queries[:N_CHECK], k=K)
        check_topk(eng, queries[:N_CHECK], vals, idx, f"{pd} at {BIG_POOL}")
        full = sync_ms(lambda: eng.query(queries, k=K), 3)
        one = sync_ms(lambda: eng.query(queries[:1], k=K), 10)
        rr = ""
        if pd == "int4":
            ms = sync_ms(lambda: eng.query_rerank(
                state, q_rerank, k=K, shortlist=SHORTLIST), 5)
            rr = f", query_rerank {N_RERANK}q S={SHORTLIST} p50 {ms:.3f} ms"
        log(f"scale {pd} at {BIG_POOL} (chunks of {CHUNK}): built in "
            f"{build_s:.3f} s, pool {gib(eng):.3f} GiB, top-{K} = brute force "
            f"on {N_CHECK} queries; query {N_QUERIES}q p50 {full:.3f} ms "
            f"({N_QUERIES * BIG_POOL / full * 1e3:.4g} pairs/s), query 1q p50 "
            f"{one:.3f} ms{rr} [{card}]")
        del eng
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    started = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from mms_answer_selection_tpu_torch.models.mms_qa import MMSQAConfig
    from mms_answer_selection_tpu_torch.ops import _build
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.serve import QueryEngine

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
    for fn, counts in sass_counts(so).items():
        log(f"sass {fn}: {counts}")
        if "maxsim" in fn and not (counts["HGMMA"] + counts["IGMMA"]
                                   and counts["HMMA"] + counts["IMMA"] == 0):
            raise AssertionError(f"{fn} does not run on wgmma alone: "
                                 f"{counts}")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # ---------------------------------------- kernel vs plain at serving widths
    w_rand = normal(M, D, D, scale=0.05)
    max_err = {name: 0.0 for name in KERNELS}
    timed = {}

    def operands(name, nq, c):
        return scorer_args(sk, name, normal(nq, W1, D, scale=0.3),
                           normal(c, W2, D, scale=0.3), w_rand)

    scorers = maxsim_scorers(sk)
    for name in MAXSIM:
        for nq in KERNEL_NQ:
            for c in KERNEL_POOLS:
                check_maxsim(sk, name, operands(name, nq, c),
                             f"nq={nq} C={c}", max_err)

    # --------------------------------------------------------------- engine
    cfg = MMSQAConfig(vocab_size=VOCAB)   # V4 at its published widths
    params, state = random_model(cfg, normal, gen, dev)
    cand_ids = torch.randint(0, VOCAB, (POOL, W2), generator=gen, device=dev)
    queries = torch.randint(0, VOCAB, (N_QUERIES, W1), generator=gen,
                            device=dev)
    q_rerank = queries[:N_RERANK]

    engines, results = {}, {}
    for pd in POOL_DTYPES:
        t0 = time.perf_counter()
        engines[pd] = QueryEngine(params, cfg, pool_dtype=pd, chunk_size=CHUNK,
                                  device=dev).build_index(cand_ids)
        torch.cuda.synchronize()
        log(f"engine {pd}: built {POOL} candidates in "
            f"{time.perf_counter() - t0:.3f} s, pool {gib(engines[pd]):.3f} "
            f"GiB, scored in chunks of {CHUNK}")

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
        check_engine(eng, cfg, state, queries, results[pd], pd)
    b_idx = results["bf16"][1]
    for pd in ("int8", "int4"):
        agree = (results[pd][1][:, :, None] == b_idx[:, None, :]).any(-1) \
            .float().mean()
        _, short = engines[pd].query(queries, k=SHORTLIST)
        recall = (b_idx[:, :, None] == short[:, None, :]).any(-1).float() \
            .mean()
        log(f"{pd} vs bf16 over {N_QUERIES} queries at {POOL}: top-{K} "
            f"agreement {float(agree):.4f}, bf16 top-{K} in {pd} top-"
            f"{SHORTLIST} recall {float(recall):.4f}")

    # ------------------------------------------- lifecycle, IVF, 1M pools
    lifecycle_phase(params, state, cfg, cand_ids, queries, dev)
    ivf_phase(params, cfg, gen, dev, card)

    # ------------------------------------------------------------- training
    train_launches = train_phase(dev, normal, card, max_err, timed)
    launches.update({k: train_launches[k] for k in KERNELS
                     if k not in MAXSIM})

    # ---------------------------------------------------------------- times
    for name, (kernel, plain) in scorers.items():
        args = operands(name, TIMED_NQ, TIMED_POOL)
        b_ms, b_by = maxsim_bound(name, args, TIMED_NQ * TIMED_POOL * 4)
        timed[name] = (burst_ms(lambda: kernel(*args), 20),
                       burst_ms(lambda: plain(*args), 5), None, b_ms, b_by)
        log(f"time {name} {TIMED_NQ}q x {TIMED_POOL}: kernel "
            f"{timed[name][0]:.4f} ms, plain {timed[name][1]:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {b_ms / timed[name][0]:.1%} of it "
            f"reached) [{card}]")
        for nq in SCAN_NQ:
            args = operands(name, nq, POOL)
            ms = burst_ms(lambda: kernel(*args), 5 if nq > 1 else 50)
            b_ms, b_by = maxsim_bound(name, args, nq * POOL * 4)
            log(f"time {name} {nq}q x {POOL}: kernel {ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of it reached) "
                f"[{card}]")
            del args
    for pd, eng in engines.items():
        one = sync_ms(lambda: eng.query(queries[:1], k=K), 20)
        full = sync_ms(lambda: eng.query(queries, k=K), 5)
        rr = sync_ms(lambda: eng.query_rerank(state, q_rerank, k=K,
                                              shortlist=SHORTLIST), 10)
        ops = (*eng.project(eng.query_tokens(queries)), eng.pool) \
            + (() if eng.aux is None else (eng.aux,))
        scan = burst_ms(lambda: scorers["maxsim_" + pd][0](*ops), 5)
        b_ms, b_by = maxsim_bound("maxsim_" + pd, ops, N_QUERIES * POOL * 4)
        log(f"time engine {pd} at {POOL}: query 1q p50 {one:.3f} ms, "
            f"query {N_QUERIES}q p50 {full:.3f} ms "
            f"({N_QUERIES * POOL / full * 1e3:.4g} pairs/s; kernel alone, "
            f"unchunked, {scan:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
            f"{b_ms / scan:.1%} of it reached)), query_rerank {N_RERANK}q "
            f"S={SHORTLIST} p50 {rr:.3f} ms [{card}]")
    del engines, results
    torch.cuda.empty_cache()
    scale_phase(params, state, cfg, queries, gen, dev, card)

    # -------------------------------------- V4_WIDE, long sentences, R = 800
    del params, state, cand_ids, queries
    torch.cuda.empty_cache()
    wide_serving_phase(sk, normal, gen, dev, card, max_err)
    wide_train_phase(dev, normal, card, max_err)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; run {time.perf_counter() - started:.1f} s, build included")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": timed[name][0], "plain_ms": timed[name][1],
         "bound_ms": timed[name][3], "bound_by": timed[name][4],
         "library_ms": timed[name][2]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
