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
* the trainer's dispatch (``dispatch_phase``): every chunk of K steps of
  ``fit``, ``fit_stream`` and ``scan_train_steps`` is one CUDA graph
  replay (``training/dispatch.py``); a 5-step graph chunk against 5 eager
  steps from one carry, dropout on, at batch 50 and 1,024; the step p50
  eager, as a K = 1 replay and per step of a K = 50 replay, in turns, at
  batch 50, 256 and 1,024, with the profiler's read of a replay (one
  ``cudaGraphLaunch``, the pair-map kernels inside, the idle share) and
  each length's capture time and graph pool; ``fit`` and ``fit_stream`` at
  K = 50, replays = chunks (a partial last chunk its own length); the
  ``fit``, CLI and multimodal runs below go through graphs too;
* the one-dispatch serving (``serve_dispatch_phase``, ``utils/graphs.py``):
  ``query`` at 1, 32 and 256 queries and ``query_rerank`` at 32 on the
  bf16, int8 and int4 engines of 262,144 and 1,048,576 candidates in
  chunks of 131,072, each one CUDA graph replay held bit for bit to the
  eager call on the same engine (``scan_chunks`` off), its top-10 to the
  plain top-10, the keys replayed out of their capture order, and timed
  in turns with the eager call (p50s, launches a replay, the profiler's
  device time and idle share, capture seconds, graph-pool growth); the
  graphs dropped and recaptured after an add past the reserve, a
  removal and ``compact`` (no removed row returned); the IVF probe at
  nprobe 8 and the T=8 coarse stage the same way in ``ivf_phase``, the
  eval step on the dev and test splits and the 301-step ``fit``'s evals
  in ``dispatch_phase``, and HTTP /query at 1 and 32 queries eager
  against replays (a padded batch answering as the engine does) in
  ``cli_phase``;
* the CLI, the path a user takes (``cli.main`` in this process, V4's
  widths, the recipe-sized corpus written as XML and a GloVe-format
  ``.txt``): ``prep --mmsp``, ``train --stream`` (the packed store's ring
  through ``next_device``) to step 200 with snapshots every 100 and
  ``--resume`` to 400 beside an uninterrupted 400-step run (from a xavier
  W: dev MAP and the last snapshot's params within a stated tolerance;
  from the recipe's W = 0: the loss falls, the two runs read against each
  other), ``eval`` of the best checkpoint (``trec_eval`` = in-graph MAP to
  1e-6), an int8 index of 262,144 candidates from it behind ``serve
  --int8 --index --listen 0`` whose /query (1 and 32 queries, with and
  without a rerank of 50), /add, /remove and /compact answer as the
  engine does, stopped through the module hook; it fails unless prep to
  eval launched the three pair-map kernels and the server's HTTP requests
  alone launched ``maxsim_int8`` and ``pair_maps_fwd``, and times the HTTP
  /query p50s, one snapshot and the stream's step against ``fit``'s;
* the generic path, the reference's own workflow (``graph_phase``): the V4
  recipe's train and eval nets as NetParameter text from
  ``net_prototxt_from_config`` at V4's widths and the corpus's vocabulary,
  an AdaDelta solver prototxt beside them, ``GraphSolver`` on the card
  over the corpus through ``feeds=``: the generic train net's fc2 against
  the typed model's logits on the same weights, one step card vs CPU
  after an SGD warm start from a xavier W, a 300-step solve from the
  recipe's W = 0 with dev tests through the eval net's MAP / MRR / AUC
  layers (held to the in-process metrics) and BINARYPROTO snapshots,
  which must launch the three pair-map kernels (the test net the
  forward), a run restored at 200 from its ``.solverstate`` against the
  uninterrupted one (xavier W), ``nettest`` on the last ``.caffemodel``
  against the solver's last MAP and ``train --weights`` of it into the
  typed ``Trainer``; the generic step's p50 at batch 50 and 1024 in turns
  with the typed one, a snapshot's and ``nettest``'s times; since PR 15
  every solver iteration, test batch, ``nettest`` and ``extract_features``
  iteration one CUDA graph replay: a replayed step against the eager
  ``_train_step`` bit for bit (batch 50 at iter_size 1 and 2, 1,024;
  dropout on; deterministic algorithms), the test pass, ``nettest``'s
  and ``extract_features``' iterations against their eager calls bit for
  bit, eager against replayed steps in turns at batch 50 and 1,024 with
  the profiler's read of each, capture s, graph-pool MiB and launches a
  replay;
* the pycaffe path, the reference QA script's own flow (``pycaffe_phase``,
  through ``caffe_compat``): the V4 recipe's train and test nets written
  with ``caffe.NetSpec`` (they parse as ``net_prototxt_from_config``'s, and
  one ``.caffemodel`` gives one loss in both), one ``solver.step(1)``
  under ``set_mode_gpu()`` against one under ``set_mode_cpu()``, a
  300-step AdaDelta solve in ``solver.step(100)`` calls from the recipe's
  W = 0 (the three pair-map kernels once a step, the train loss falls,
  ``solver.test_nets[0]``'s MAP / MRR blobs = the in-process metrics,
  ``caffe.Net(test, caffe.TEST, weights=snapshot)`` = the solver's test
  net, the ``net.blobs[...].data[...] = x`` idiom = ``forward(**x)``);
  4,096 synthetic 3 x 32 x 32 images through ``convert_imageset`` into an
  LMDB and a LevelDB (their first Data-layer batches equal), a conv net
  trained 200 steps on the LMDB through ``solve``, ``extract_features``
  against ``caffe.Net``, a WindowData net for 20 steps, and ``classify``,
  ``detect``, ``draw``, ``upgrade --binary`` and ``convert`` against
  their in-process counterparts; the pycaffe step's p50 at batch 50 and
  1024 in turns with GraphSolver's, the Data feeds' and ``classify``'s
  images/s; since PR 15 the pycaffe step (a replay) against the eager
  step and GraphSolver's replay in turns, and ``solver.net.forward()``,
  ``solver.test_nets[0].forward()`` and ``caffe.Net.forward`` replays
  against their eager calls bit for bit, each timed;
* V4_WIDE (D = 300) and long sentences: each MaxSim kernel against its
  plain version at D = 300 (rows past 256 bytes, the K-sliced plan) and
  at R = 800 query rows (W1 = 200, D = 50 and 300), a 262,144-candidate
  V4_WIDE engine of each dtype in turn, freed before the next, through
  the same checks as V4's, the pair-map kernels at (W1, W2) past 64 rows
  at D = 50 and 300, one V4_WIDE train step on the card against the CPU,
  and its step p50 at batch 50 and 1024;
* the multimodal side (configs[4]) at its published defaults: the
  pair-map kernels at (W1, W2, M) = (12, 25, 2) and the MaxSim kernels at
  R = 24 query rows, W2P = 32 against their plain versions, 200
  caption-to-image AdaDelta steps through ``Trainer(apply_fn=
  caption_image_apply, init_fn=caption_image_init)`` on a planted-signal
  corpus (rank accuracy must rise, card = CPU after 1 and 3 steps, the
  pair-map kernels' launches counted), 262,144 images encoded in chunks
  into bf16, int8 and int4 engines (``build_index_from_tokens`` from the
  host) queried with 1 and 256 captions (top-10 = brute force, p50s,
  overlap with the float32 scorer), and 100 image-pair steps from
  ``PairImageDataset`` (the loss falls, card = CPU after one);
* the rest of the package (``tail_phase``, V4 at full width): ``time`` at
  batch 50 and 1,024 (the per-stage table; the three pair-map kernels
  must launch), on the recipe's train net as a deploy-style prototxt and
  over a 262,144-candidate int8 pool (``maxsim_int8`` must launch); a
  scorer exported on the card and loaded, called at batch 1, 50 and
  1,024 (within 1e-5 of the live model's max |logit|, one
  ``pair_maps_fwd`` launch a call); the bf16 forward at batch 1,024
  against float32 (P moved by 1e-5 to 7.5e-5); 20 recipe steps through
  ``Trainer(mesh=make_mesh(1))`` over one NCCL rank (the plain Trainer bit
  for bit) and over two gloo ranks sharing the card (rtol = atol = 1e-4),
  one tp = 2 step against the unsharded one, a 262,144-candidate int8 and
  bf16 pool split over the two ranks (the one-process top-10 bit for
  bit, each rank launching the pair-map kernels in its dp and tp steps
  and its pool's MaxSim kernel); ``cli matbridge`` in its own process
  driven over its socket and held to in-process pycaffe; ``plot`` (or its refusal without
  matplotlib);
* the examples (``examples_phase``): the JAX package's example scripts as
  the port's twins (``mms_answer_selection_tpu_torch/examples``), each
  through its ``main`` on the card: the recipe rehearsal with ``--hard``
  (3,001 steps, patience 5; its own ``trec_eval`` parity and min-gain
  asserts), ``trec_qa_mms`` in smoke mode, ``retrieval_1m`` at 1,048,576
  int8 candidates and at 262,144 bf16 with IVF and the coarse shortlist,
  ``serve_load`` at its defaults, the full int8 error analysis into a
  temporary directory and ``pair_image_metric``; a line each with its
  wall and launches, failing unless the recipe and ``trec_qa_mms``
  launched the three pair-map kernels, the int8 legs ``maxsim_int8`` and
  the bf16 legs and IVF ``maxsim_bf16``;

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
single PyTorch call computes the function); lines before it, the
launches of the dispatch, the generic, the pycaffe, the multimodal, the
tail and the examples' paths.  About 320-420 s on an H100, build
included, peaking near 28 GiB of device memory.
"""

from __future__ import annotations

import contextlib
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
# the one-dispatch serving (serve_dispatch_phase): query at DISPATCH_NQ
# queries and the rerank at N_RERANK, each a graph replay in turns with
# the eager path on the same engine
DISPATCH_NQ = (1, 32, N_QUERIES)
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
# the dispatch path (dispatch_phase): a DISPATCH_CHECK_K-step graph chunk
# against as many eager steps from one carry at DISPATCH_CHECK_BATCHES,
# dropout on (loss within MM_LOSS_RTOL relative, params within rtol 1e-4 +
# atol 1e-5, conv biases within AdaDelta's band a step); the step p50
# eager, as a K = 1 graph and per step of a K = DISPATCH_K graph, in turns,
# at STEP_BATCHES, the profiler's read of one K = DISPATCH_K replay; fit
# for FIT_STEPS and fit_stream for DISPATCH_STREAM_STEPS steps at K =
# DISPATCH_K, each chunk one replay
DISPATCH_CHECK_K, DISPATCH_K, DISPATCH_STREAM_STEPS = 5, 50, 130
DISPATCH_CHECK_BATCHES = (BATCH, 1024)
# the CLI path: train --stream to step CLI_SPLIT - 1, --resume to
# CLI_STEPS - 1, beside one uninterrupted run (evals and snapshots every
# 100 steps); an int8 index of POOL candidates behind serve --listen,
# each HTTP route timed over HTTP_REPS requests
CLI_SPLIT, CLI_STEPS, SNAP_EVERY, HTTP_REPS = 201, 401, 100, 30
STREAM_STEP_REPS = 200
# a resumed run on the card against the uninterrupted one: the runs part by
# rounding (the embedding-gradient scatter sums in the order its atomics
# land), so dev MAP is held to RESUME_MAP_ATOL and each param (but the conv
# biases, rounding noise under train-mode BN) to RESUME_PARAM_RTOL of its
# max |value| (an H100 run read 0 and 3.1e-6).  The held runs start from
# a xavier W: from the recipe's W = 0 the first step's scores are near-ties
# that rounding orders, so any two card runs part at step 0 (dev MAP 0.451
# / 0.439 after it); the W = 0 runs are read, not held
RESUME_MAP_ATOL, RESUME_PARAM_RTOL = 5e-3, 1e-3
CLI_TRAIN_KERNELS = ("pair_maps_fwd", "pair_maps_bwd_w", "pair_maps_bwd_qa")
# the generic path (GraphSolver over the recipe's own net prototxts): a
# GRAPH_STEPS-step solve with dev tests and BINARYPROTO snapshots every
# GRAPH_EVERY steps, a run restored at GRAPH_RESUME_AT against the
# uninterrupted one, card vs CPU after GRAPH_WARM_STEPS SGD steps, the
# step timed at GRAPH_TIMED batches
GRAPH_STEPS, GRAPH_EVERY, GRAPH_RESUME_AT, GRAPH_WARM_STEPS = 300, 100, 200, 5
GRAPH_TIMED = (BATCH, 1024)
# replayed GraphSolver steps held to eager ones, bit for bit: (batch,
# iter_size) cells, GRAPH_CHECK_STEPS steps each
GRAPH_CHECK = ((BATCH, 1), (BATCH, 2), (1024, 1))
GRAPH_CHECK_STEPS = 3
# the pycaffe path (caffe_compat: NetSpec nets, get_solver, caffe.Net): a
# PYCAFFE_STEPS-step solve in solver.step(PYCAFFE_EVERY) calls, the step
# timed at PYCAFFE_TIMED batches; the databases: DB_IMAGES synthetic
# DB_HW x DB_HW x 3 images of DB_CLASSES classes through convert_imageset
# into an LMDB and a LevelDB, a conv net trained DB_STEPS steps on the
# LMDB at batch DB_BATCH, a WindowData net WINDOW_STEPS steps over
# WINDOW_IMAGES of them, classify over CLASSIFY_IMAGES
PYCAFFE_STEPS, PYCAFFE_EVERY, PYCAFFE_TIMED = 300, 100, (BATCH, 1024)
DB_IMAGES, DB_HW, DB_CLASSES, DB_BATCH, DB_STEPS = 4096, 32, 10, 64, 200
WINDOW_IMAGES, WINDOW_STEPS, CLASSIFY_IMAGES = 256, 20, 16
CLI_SERVE_KERNELS = ("maxsim_int8", "pair_maps_fwd")   # query, the rerank

# the multimodal side (configs[4]) at CaptionImageConfig()'s and
# PairImageConfig()'s published defaults: captions of 12 tokens, 16 x 16 x 3
# images, P = 25 patch tokens, D = 50, M = 2, so the pair maps run at (W1,
# W2, M) = (12, 25, 2) and MaxSim at R = 24 query rows, W2P = 32.  Caption
# training: MM_STEPS AdaDelta steps at batch BATCH on a planted-signal
# corpus (pixel row f of the positive image encodes the caption's token
# f), card against CPU after MM_CHECK_STEPS; an image pool of POOL images
# encoded in chunks of MM_ENCODE_CHUNK; PAIR_STEPS image-pair steps
MM_W1, MM_P, MM_M = 12, 25, 2
MM_PAIR_CHECKS = ((BATCH, MM_W1, MM_P, D, MM_M),
                  (1024, MM_W1, MM_P, D, MM_M))
MM_KERNEL_NQ = (1, 16, N_QUERIES)
MM_STEPS, MM_ACC_WINDOW, MM_CHECK_STEPS = 200, 20, (1, 3)
MM_ENCODE_CHUNK = 32_768
PAIR_STEPS, PAIR_CORPUS = 100, 1000
# card against CPU on the same weights and batches, each param leaf's max
# abs difference over its max |value| (conv biases apart: rounding noise
# under train-mode BN, held to AdaDelta's band; so is the image-pair score
# bias, which the loss reads only through score differences).  An H100
# 80GB HBM3 at 700 W read the loss 2.1e-7 / 7.3e-7 relative and the params
# 9.0e-6 / 5.8e-6 apart after 1 / 3 caption steps, the image-pair step
# 0 and 5.3e-6
MM_LOSS_RTOL, MM_PARAM_RTOL = 1e-5, 1e-4
MM_NOISE_LEAVES = ("conv0.b", "conv1.b", "score.b")

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


def in_turns(kernel, plain, ops, k_reps: int = 100, p_reps: int = 30):
    """``burst_ms`` of ``kernel(*ops)`` and ``plain(*ops)`` in turns: plain,
    kernel, kernel, plain.  Returns (kernel ms, plain ms, the four)."""
    t = [burst_ms(lambda: plain(*ops), p_reps),
         burst_ms(lambda: kernel(*ops), k_reps),
         burst_ms(lambda: kernel(*ops), k_reps),
         burst_ms(lambda: plain(*ops), p_reps)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def bound_ms(name: str, ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak for the kernel's operand
    type; and which of the two it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[BOUND_TYPE[name]] * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def pair_bound(name: str, n: int, d: int, w1: int = W1, w2: int = W2,
               m: int = M) -> tuple[float, str]:
    """``bound_ms`` of a pair-map kernel (V4's W1 = W2 = 40, M = 4 unless
    given): 2 N M W1 D (D + W2) operations (twice that for dQ and dA
    together), each input read and each output written once."""
    ops = 2 * n * m * w1 * d * (d + w2) * (2 if name == "pair_maps_bwd_qa"
                                            else 1)
    q, a, w, g = n * w1 * d, n * w2 * d, m * d * d, n * w1 * w2 * m
    floats = {"pair_maps_fwd": q + a + w + g,
              "pair_maps_bwd_w": q + a + g + w,
              "pair_maps_bwd_qa": q + a + w + g + q + a}[name]
    return bound_ms(name, ops, 4 * floats)


def maxsim_bound(name: str, args, out_bytes: int, d: int = D,
                 r: int = M * W1, w2: int = W2) -> tuple[float, str]:
    """``bound_ms`` of a MaxSim kernel: 2 x Nq R x C x W2 x D operations
    (the unpadded widths: R = M W1 projected query rows, W2 candidate
    tokens; V4's unless given), the operands as given read once and the
    scores written once."""
    nq, c = args[0].shape[0], args[2 if len(args) > 2 else 1].shape[0]
    ops = 2 * nq * r * c * w2 * d
    nbytes = sum(t.numel() * t.element_size() for t in args) + out_bytes
    return bound_ms(name, ops, nbytes)


def recipe_xml(dim: int):
    """The recipe-sized synthetic TREC-QA corpus (50,093 / 1,195 / 1,569
    pairs) as the three splits' XML and the word vectors of ``dim``
    lanes."""
    from mms_answer_selection_tpu_torch.data import (
        synthetic_split, synthetic_world)

    world = synthetic_world(vocab_words=22500, n_topics=250, dim=dim, seed=22)
    xmls = (synthetic_split(world, TRAIN_Q, 30, 50, seed=101),
            synthetic_split(world, DEV_Q, 12, 24, seed=202),
            synthetic_split(world, TEST_Q, 15, 29, seed=303))
    return xmls, world["w2v"]


def recipe_corpus(dim: int):
    """The recipe-sized corpus, prepped: (splits, vocab info, host prep
    seconds)."""
    from mms_answer_selection_tpu_torch.data import prepare_trec_qa

    t0 = time.perf_counter()
    xmls, w2v = recipe_xml(dim)
    splits, info = prepare_trec_qa(*xmls, w2v)
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


def pair_operands(normal, n: int, d: int, w1: int = W1, w2: int = W2,
                  m: int = M):
    """q, a, W and dL/dout of a pair-map call (M = 4 unless given)."""
    return (normal(n, w1, d, scale=0.3), normal(n, w2, d, scale=0.3),
            normal(m, d, d, scale=0.05), normal(n, w1, w2, m))


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
    w2, m = ops[1].shape[1], ops[2].shape[0]
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
            log(f"check {name} N={n} W1={w1} W2={w2} D={d} M={m} out "
                f"{tuple(x.shape)}: max_abs_err {err:.3e}, max_rel_err "
                f"{rel:.3e} (rtol {rtol:g} of the output's max |value|)")
            if rel > rtol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rel:.3e} > {rtol:g}")
    if not torch.equal(sk.pair_maps_bwd_w(*ops), sk.pair_maps_bwd_w(*ops)):
        raise AssertionError(f"pair_maps_bwd_w: dW differs between two runs "
                             f"at N={n} W1={w1} W2={w2} D={d} M={m}")


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
    the launch counts of the ``fit`` run, and the corpus (splits, vocab
    info)."""
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
    chunks = len(chunk_lengths(0, FIT_STEPS, 1, [TEST_INTERVAL]))
    capture_costs(trainer.runner, f"fit batch {BATCH}", card)
    if trainer.runner.replays != chunks:
        raise AssertionError(f"fit ran {chunks} chunks but replayed "
                             f"{trainer.runner.replays} graphs")
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
            k_ms, p_ms, t = in_turns(*pairs[name], ops)
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
        f"{len(hist['steps'])} dev+test evals, K=1 (each step one graph "
        f"replay): {fit_s:.3f} s ({FIT_STEPS / fit_s:.2f} steps/s); host "
        f"data prep {prep_s:.3f} s [{card}]")
    return launches, splits, info


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


def chunk_lengths(it: int, steps: int, k: int, intervals) -> list:
    """The lengths of the chunks ``Trainer._loop`` runs from step ``it``
    until ``steps``."""
    from mms_answer_selection_tpu_torch.training import Trainer

    lengths = []
    while it < steps:
        lengths.append(Trainer._plan_chunk(it, k, steps - it, intervals))
        it += lengths[-1]
    return lengths


def corpus_batches(tr, splits, n: int) -> list:
    """The first ``n`` batches of ``tr``'s shuffled passes over the train
    split, on the device."""
    import itertools

    train = tr._full_batch({k: v for k, v in splits["train"].items()
                            if k != "group"})
    passes = (tr._epoch_batches(train, e) for e in itertools.count())
    return list(itertools.islice(itertools.chain.from_iterable(passes), n))


def capture_costs(runner, label: str, card: str) -> None:
    """A line per chunk length the runner captured."""
    for c in sorted(runner.stats(), key=lambda c: c["k"]):
        log(f"capture {label} K={c['k']}: {c['capture_s']:.3f} s (capture "
            f"and instantiate), graph pool {c['pool_bytes'] / 2**20:.1f} "
            f"MiB, a replay launches {c['tally']}, {c['replays']} replays "
            f"[{card}]")


def graph_vs_eager(model, tcfg, splits, info, dev, b: int) -> None:
    """A DISPATCH_CHECK_K-step chunk as one graph replay against as many
    eager ``_train_step`` calls from the same carry on the same batches,
    dropout on."""
    from mms_answer_selection_tpu_torch.training import Trainer

    tr = Trainer(model, tcfg, device=dev)
    p0, s0, o0 = tr.init(pretrained=info["pretrained"])
    batches = corpus_batches(tr, splits, DISPATCH_CHECK_K)
    p, s, o, want = p0, s0, o0, []
    for i, batch in enumerate(batches):
        p, s, o, loss = tr._train_step(p, s, o, batch, i)
        want.append(loss)
    stacked = {k: torch.stack([x[k] for x in batches]) for k in batches[0]}
    gp, _, _, got = tr.scan_train_steps(p0, s0, o0, stacked, 0)
    want = torch.stack(want)
    if tr.runner.replays != 1 or not tr.runner.captures:
        raise AssertionError("the chunk was not one graph replay")
    loss_rel = float(((got - want).abs() / want.abs()).max())
    worst, where, band = 0.0, "", 2 * 2 * ADADELTA_STEP * DISPATCH_CHECK_K
    for name, sub in p.items():
        for k, w in sub.items():
            diff = float((gp[name][k] - w).abs().max())
            if name.startswith("conv") and k == "b":
                ok = diff <= band
            else:
                ok = torch.allclose(gp[name][k], w, rtol=1e-4, atol=1e-5)
                if diff > worst:
                    worst, where = diff, f"{name}.{k}"
            if not ok:
                raise AssertionError(f"graph chunk at batch {b}: {name}.{k} "
                                     f"{diff:.3e} from the eager steps")
    log(f"check graph chunk vs eager steps (V4, batch {b}, "
        f"{DISPATCH_CHECK_K} steps, dropout on, xavier W): losses "
        f"{[round(float(x), 6) for x in got]}, max rel diff {loss_rel:.3e} "
        f"(tol {MM_LOSS_RTOL:g}); params max abs diff {worst:.3e} at {where}"
        f" (rtol 1e-4, atol 1e-5; conv biases within {band:.3e})")
    if loss_rel > MM_LOSS_RTOL:
        raise AssertionError(f"graph chunk at batch {b}: losses differ")


def dispatch_times(model, tcfg, splits, info, dev, b: int,
                   card: str) -> None:
    """Step p50 at batch ``b``: eager, one K = 1 replay, and a K =
    DISPATCH_K replay per step (host wall of calls each ended by a sync,
    capture off the clock), in turns; the profiler's read of one eager
    step and one K = DISPATCH_K replay."""
    from torch.autograd import DeviceType

    from mms_answer_selection_tpu_torch.training import Trainer

    tr = Trainer(model, tcfg, device=dev)
    p, s, o = tr.init(pretrained=info["pretrained"])
    batches = corpus_batches(tr, splits, DISPATCH_K)
    runner = tr._runner_for((p, s, o))
    reps = max(5, 1000 // b)
    modes = {"eager": (lambda: tr._train_step(p, s, o, batches[0], 0),
                       reps, 1),
             "K=1": (lambda: runner.run(batches[:1], 0), reps, 1),
             f"K={DISPATCH_K}": (lambda: runner.run(batches, 0),
                                 max(2, 200 // b), DISPATCH_K)}
    times = {m: [] for m in modes}
    for m in [*modes, *reversed(modes)]:
        fn, r, k = modes[m]
        times[m].append(sync_ms(fn, r) / k)
    p50 = {m: sum(t) / 2 for m, t in times.items()}
    prof = {}
    for m in ("eager", f"K={DISPATCH_K}"):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as pr:
            modes[m][0]()
            torch.cuda.synchronize()
        rows = pr.key_averages()
        on_dev = [e for e in rows if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in on_dev) / 1e3
        calls = {e.key: e.count for e in rows if e.key in (
            "cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernel", "cudaMemcpyAsync")}
        pair = {n: sum(e.count for e in on_dev if n + "_kernel" in e.key)
                for n in CLI_TRAIN_KERNELS}
        wall = p50[m] * modes[m][2]
        prof[m] = {"device_ops": sum(e.count for e in on_dev),
                   "device_ms": busy, "idle": max(0.0, 1 - busy / wall),
                   "host_calls": calls, "pair_map_kernels": pair}
    replay = prof[f"K={DISPATCH_K}"]
    log(f"time train step V4 batch {b}: eager p50 {p50['eager']:.3f} ms, "
        f"K=1 graph p50 {p50['K=1']:.3f} ms, K={DISPATCH_K} graph "
        f"{p50[f'K={DISPATCH_K}']:.3f} ms a step (each the mean of two "
        f"turns: {({m: [round(x, 3) for x in t] for m, t in times.items()})}"
        f"); profiler: eager step {prof['eager']['device_ops']} device ops, "
        f"{prof['eager']['device_ms']:.3f} ms device time, idle "
        f"{prof['eager']['idle']:.1%}, host {prof['eager']['host_calls']}; "
        f"one K={DISPATCH_K} replay {replay['device_ops']} device ops, "
        f"{replay['device_ms']:.3f} ms device time ("
        f"{replay['device_ms'] / DISPATCH_K:.3f} ms a step), idle "
        f"{replay['idle']:.1%}, host {replay['host_calls']}, pair-map "
        f"kernels {replay['pair_map_kernels']} [{card}]")
    if replay["host_calls"].get("cudaGraphLaunch") != 1 or any(
            n < DISPATCH_K for n in replay["pair_map_kernels"].values()):
        raise AssertionError(f"a K={DISPATCH_K} chunk is not one graph "
                             f"launch running the pair-map kernels: {replay}")
    capture_costs(runner, f"V4 batch {b}", card)


def dispatch_phase(dev, card: str, splits, info) -> dict:
    """The trainer's dispatch: every chunk of K steps one CUDA graph
    replay.  Holds a K-step graph chunk to as many eager steps at batch 50
    and 1,024, times eager steps against K = 1 and K = DISPATCH_K replays
    at STEP_BATCHES with the profiler's read of a replay (one
    ``cudaGraphLaunch``, the pair-map kernels inside), and runs ``fit``
    and ``fit_stream`` at K = DISPATCH_K (replays = chunks).  Returns the
    launches of the fit and fit_stream runs."""
    import dataclasses

    import numpy as np

    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.training import Trainer

    started = time.perf_counter()
    tcfg = recipe_trainer()
    model = dataclasses.replace(V4, vocab_size=info["vocab_size"])
    xavier = dataclasses.replace(model, sim_weight_init="xavier")
    for b in DISPATCH_CHECK_BATCHES:
        graph_vs_eager(xavier, dataclasses.replace(tcfg, batch_size=b),
                       splits, info, dev, b)
    for b in STEP_BATCHES:
        dispatch_times(model, dataclasses.replace(tcfg, batch_size=b),
                       splits, info, dev, b, card)

    # fit and fit_stream through K = DISPATCH_K graphs, counts from 0
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    tr = Trainer(model, tcfg, device=dev)
    t0 = time.perf_counter()
    hist = tr.fit(splits["train"], splits["dev"], test_data=splits["test"],
                  pretrained=info["pretrained"],
                  steps_per_dispatch=DISPATCH_K)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    chunks = len(chunk_lengths(0, FIT_STEPS, DISPATCH_K, [TEST_INTERVAL]))
    losses = np.asarray(hist["train_loss"])
    log(f"time fit {FIT_STEPS} steps at batch {BATCH}, K={DISPATCH_K}: "
        f"{fit_s:.3f} s ({FIT_STEPS / fit_s:.2f} steps/s), {chunks} chunks, "
        f"{tr.runner.replays} graph replays; loss {losses[0]:.4f} -> "
        f"{losses[-5:].mean():.4f}, dev MAP "
        f"{[round(float(x), 4) for x in hist['dev_map']]} [{card}]")
    capture_costs(tr.runner, f"fit batch {BATCH}", card)
    if tr.runner.replays != chunks or hist["steps"] != list(
            range(0, FIT_STEPS, TEST_INTERVAL)) \
            or not np.isfinite(losses).all() \
            or not losses[-5:].mean() < losses[0]:
        raise AssertionError(f"fit at K={DISPATCH_K}: {tr.runner.stats()}")
    # its evals: one replay per split and eval, a graph per split shape
    evals = len(hist["steps"])
    log(f"fit's evals: {tr.evals.replays} replays of "
        f"{len(tr.evals.keys())} eval graphs ({evals} evals on dev and "
        f"test): " + "; ".join(
            f"capture {st['capture_s']:.3f} s, graph pool +"
            f"{st['pool_bytes'] / 2**20:.1f} MiB, a replay launches "
            f"{st['tally']}" for st in tr.evals.stats()) + f" [{card}]")
    if tr.evals.replays != 2 * evals or len(tr.evals.keys()) != 2:
        raise AssertionError(f"fit's evals: {tr.evals.stats()}")
    # the eval step alone on the last carry: replay against eager
    p, s, _ = tr.runner.carry
    tr.evals.drop()
    for name in ("dev", "test"):
        batch = tr._full_batch(splits[name])
        graphed_vs_eager(f"eval step {name} ({len(splits[name]['label'])} "
                         f"pairs)", tr.evals,
                         lambda: tr._eval_step(p, s, batch),
                         lambda: tr._eval_body(p, s, batch), 20, card)
    stream = corpus_batches(tr, splits, DISPATCH_STREAM_STEPS)
    tr = Trainer(model, tcfg, device=dev)
    shist = tr.fit_stream(iter([{k: v.cpu().numpy() for k, v in b.items()}
                                for b in stream]), splits["dev"],
                          steps=10 * DISPATCH_STREAM_STEPS,
                          pretrained=info["pretrained"],
                          steps_per_dispatch=DISPATCH_K)
    torch.cuda.synchronize()
    planned = chunk_lengths(0, DISPATCH_STREAM_STEPS, DISPATCH_K,
                            [TEST_INTERVAL])
    lengths = sorted(c["k"] for c in tr.runner.stats())
    log(f"fit_stream over {DISPATCH_STREAM_STEPS} batches at K="
        f"{DISPATCH_K}: {len(shist['train_loss'])} loss records, evals at "
        f"{shist['steps']}, {tr.runner.replays} replays of graphs of "
        f"{lengths} steps (the iterator's last, partial chunk its own)")
    if tr.runner.replays != len(planned) or lengths != sorted(set(planned)):
        raise AssertionError(f"fit_stream: {tr.runner.stats()}")
    launches = dict(sk.LAUNCH_COUNTS)
    for name in CLI_TRAIN_KERNELS:
        if launches[name] < FIT_STEPS:
            raise AssertionError(f"the dispatch path launched {name} "
                                 f"{launches[name]} times")
    log(f"dispatch phase: {time.perf_counter() - started:.1f} s")
    return launches


def profile_call(call) -> dict:
    """``torch.profiler``'s read of one ``call()``: device ops and device
    time (the CUDA rows' self time), and the host's launch calls."""
    from torch.autograd import DeviceType

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as pr:
        call()
        torch.cuda.synchronize()
    rows = pr.key_averages()
    on_dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    return {"device_ops": sum(e.count for e in on_dev),
            "device_ms": sum(e.self_device_time_total for e in on_dev) / 1e3,
            "host_calls": {e.key: e.count for e in rows if e.key in (
                "cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cudaMemcpyAsync")}}


def same_tensors(got, want) -> bool:
    """Equal trees of tensors (tuples or dicts, None leaves), bit for bit."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            same_tensors(got[k], want[k]) for k in want)
    if isinstance(want, tuple):
        return len(got) == len(want) and all(
            same_tensors(a, b) for a, b in zip(got, want))
    return (got is want is None) or torch.equal(got, want)


def graphed_vs_eager(label: str, calls, graphed, eager, reps: int,
                     card: str):
    """One graphed path against its eager twin: ``graphed()`` (captured at
    its first call, then a replay) must equal ``eager()`` bit for bit;
    then the p50 of each in turns (eager, replay, replay, eager, each the
    median of ``reps`` calls ended by a sync), the profiler's read of one
    call of each (device time; idle share against the p50), and the
    graph's capture seconds, pool growth and tally from ``calls`` (the
    owner's ``GraphedCall``).  Fails unless a replay is one
    ``cudaGraphLaunch``.  Returns (eager result, a dict of the numbers)."""
    want = eager()
    known = {k for k, s in zip(calls.keys(), calls.stats()) if s["replays"]}
    for turn in ("capture", "replay"):
        if not same_tensors(graphed(), want):
            raise AssertionError(f"{label}: the graph's {turn} differs from "
                                 f"the eager call")
    new = [s for k, s in zip(calls.keys(), calls.stats())
           if s["replays"] and k not in known]
    if len(new) != 1:
        raise AssertionError(f"{label}: {len(new)} graphs captured, not 1")
    (st,) = new
    times = {"eager": [], "replay": []}
    for mode in ("eager", "replay", "replay", "eager"):
        times[mode].append(sync_ms(graphed if mode == "replay" else eager,
                                   reps))
    p50 = {m: sum(t) / 2 for m, t in times.items()}
    prof = {m: profile_call(graphed if m == "replay" else eager)
            for m in p50}
    for m, pr in prof.items():
        pr["idle"] = max(0.0, 1 - pr["device_ms"] / p50[m])
    if prof["replay"]["host_calls"].get("cudaGraphLaunch") != 1:
        raise AssertionError(f"{label}: a replay is not one graph launch: "
                             f"{prof['replay']}")
    out = {"eager_ms": p50["eager"], "replay_ms": p50["replay"],
           "turns": times, "tally": st["tally"],
           "capture_s": st["capture_s"],
           "pool_mib": st["pool_bytes"] / 2**20, "profile": prof}
    log(f"dispatch {label}: eager p50 {p50['eager']:.3f} ms, replay p50 "
        f"{p50['replay']:.3f} ms ({p50['eager'] / p50['replay']:.3f}x; "
        f"turns {({m: [round(x, 3) for x in t] for m, t in times.items()})}"
        f"); a replay launches {st['tally']}; profiler: eager "
        f"{prof['eager']['device_ops']} device ops, "
        f"{prof['eager']['device_ms']:.3f} ms device time, idle "
        f"{prof['eager']['idle']:.1%}; replay {prof['replay']['device_ops']}"
        f" device ops, {prof['replay']['device_ms']:.3f} ms, idle "
        f"{prof['replay']['idle']:.1%}, host {prof['replay']['host_calls']}"
        f"; capture {st['capture_s']:.3f} s, graph pool +"
        f"{st['pool_bytes'] / 2**20:.1f} MiB [{card}]")
    return want, out


def capture_off(calls, call):
    """``call`` with ``calls`` (a ``GraphedCall``) not capturing: the same
    body run eagerly on the same static buffers."""
    def eager():
        calls.captures = False
        try:
            return call()
        finally:
            calls.captures = True
    return eager


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic kernels: the embedding gradient's scatter then
    sums in one order, so two runs of a step agree bit for bit (by default
    two eager steps part in the last bits)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def solver_leaves(gs) -> dict:
    """A GraphSolver's params, BN state and solver history by leaf name."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = v

    for name in ("params", "state", "opt_state"):
        walk(getattr(gs, name), name + ".")
    return out


def engine_dispatch(eng, state, queries, label: str, card: str) -> dict:
    """``query`` at DISPATCH_NQ queries and ``query_rerank`` at N_RERANK,
    each as a graph replay against the eager path on ``eng`` (its
    ``scan_chunks`` toggled); the query's top-K held to the plain top-K
    on N_CHECK rows; the keys then replayed in another order than their
    capture, each equal to its eager result.  Returns the numbers."""
    def on(flag, fn):
        def call():
            eng.scan_chunks = flag
            return fn()
        return call

    paths = {f"query {nq} q": (lambda nq=nq: eng.query(queries[:nq], k=K),
                               max(3, 40 // nq) if nq < 256 else 3)
             for nq in DISPATCH_NQ}
    paths[f"rerank {N_RERANK} q S={SHORTLIST}"] = (
        lambda: eng.query_rerank(state, queries[:N_RERANK], k=K,
                                 shortlist=SHORTLIST), 10)
    results, numbers = {}, {}
    eng._calls.drop()                 # each path captured here, afresh
    for name, (fn, reps) in paths.items():
        results[name], numbers[name] = graphed_vs_eager(
            f"{label} {name}", eng._calls, on(True, fn), on(False, fn), reps,
            card)
        if name.startswith("query"):
            n = min(N_CHECK, len(results[name][0]))
            check_topk(eng, queries[:n], results[name][0][:n],
                       results[name][1][:n], f"{label} {name} replay")
    eng.scan_chunks = True
    for name in reversed(list(paths)):           # out of capture order
        if not same_tensors(paths[name][0](), results[name]):
            raise AssertionError(f"{label} {name}: a replay out of capture "
                                 f"order differs from the eager call")
    return numbers


def lifecycle_dispatch(params, state, cfg, cand_ids, queries, dev) -> None:
    """After an add past the reserve, a removal and ``compact``, each path
    replayed on a graphed int8 engine equals the same engine's eager call,
    and no removed row comes back."""
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    q = queries[:8]
    eng = QueryEngine(params, cfg, pool_dtype="int8", chunk_size=LIFE_CHUNK,
                      device=dev).build_index(cand_ids[:LIFE_POOL],
                                              reserve=LIFE_RESERVE)
    _, top = eng.query(q, k=K)
    dead = sorted(set(top[:, :3].flatten().tolist()) | {0, LIFE_POOL - 1})
    steps = (("add", lambda: eng.add_candidates(
                  cand_ids[LIFE_POOL:LIFE_POOL + LIFE_RESERVE + 10])),
             ("remove", lambda: eng.remove_candidates(dead)),
             ("compact", lambda: eng.compact()))
    for what, op in steps:
        version = eng.version
        op()
        if eng.version == version or eng._calls.keys():
            raise AssertionError(f"lifecycle {what}: the graphs were kept")
        out = {}
        for flag in (False, True, True):        # eager, capture, replay
            eng.scan_chunks = flag
            out[flag] = (eng.query(q, k=K), eng.query_rerank(
                state, q, k=K, shortlist=SHORTLIST))
            if flag and not same_tensors(out[True], out[False]):
                raise AssertionError(f"lifecycle {what}: a graph differs "
                                     f"from the eager call")
        if what == "remove" and set(dead) & set(
                torch.cat([out[True][0][1], out[True][1][1]]).flatten()
                .tolist()):
            raise AssertionError("lifecycle: a removed row came back")
    log(f"dispatch lifecycle int8 at {LIFE_POOL} (+{LIFE_RESERVE} reserve, "
        f"chunk {LIFE_CHUNK}): after add past the reserve, remove and "
        f"compact every graph was dropped, the recaptured query and rerank "
        f"= eager bit for bit, {len(dead)} removed rows never returned")


def serve_dispatch_phase(params, state, cfg, engines, queries, dev,
                         card: str) -> dict:
    """The one-dispatch serving (``utils/graphs.py``): ``query`` at 1, 32
    and 256 queries and ``query_rerank`` at 32 as graph replays against
    the eager calls on the same engines, bf16, int8 and int4, at POOL (the
    main path's engines) and at BIG_POOL (built here, one at a time), in
    chunks of CHUNK; the lifecycle gate.  (IVF and the coarse stage are
    held in ``ivf_phase``, HTTP in ``cli_phase``, the eval step in
    ``dispatch_phase``.)  Returns the numbers."""
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    started = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    numbers = {}
    for pd, eng in engines.items():
        numbers[pd, POOL] = engine_dispatch(eng, state, queries,
                                            f"{pd} at {POOL}", card)
    cand = torch.randint(0, VOCAB, (BIG_POOL, W2), generator=gen, device=dev)
    for pd in POOL_DTYPES:
        eng = QueryEngine(params, cfg, pool_dtype=pd, chunk_size=CHUNK,
                          device=dev).build_index(cand)
        numbers[pd, BIG_POOL] = engine_dispatch(eng, state, queries,
                                                f"{pd} at {BIG_POOL}", card)
        del eng
        torch.cuda.empty_cache()
    del cand
    lifecycle_dispatch(params, state, cfg, torch.randint(
        0, VOCAB, (LIFE_POOL + LIFE_RESERVE + 10, W2), generator=gen,
        device=dev), queries, dev)
    log(f"serve dispatch phase: {time.perf_counter() - started:.1f} s")
    return numbers


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
    from mms_answer_selection_tpu_torch.serve import topk
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
        if pd == "int8":
            # the candidate-major int8 kernel's shape (PERF.md §6 row 3):
            # one query against the rows of its nprobe 8 best buckets,
            # gathered as IVFIndex.query gathers them
            q_tok = eng.query_tokens(q[:1])
            proj = eng.project(q_tok)
            u = ivf._route(q_tok, proj).to(torch.float32).sum(1)[
                :, :ivf.centroids.shape[1]]
            _, cl = topk(u @ ivf.centroids.T, 8)
            rows = ivf.bucket_map[cl[0]].reshape(-1).clamp(min=0)
            args = (*proj, eng.pool[rows], eng.aux[rows])
            probe_ms = burst_ms(
                lambda: sk.bilinear_maxsim_scores_int8(*args), 200)
            plain_ms = burst_ms(
                lambda: sk.bilinear_maxsim_scores_int8_plain(*args), 20)
            b_ms, b_by = maxsim_bound("maxsim_int8", args, rows.numel() * 4)
            log(f"time maxsim_int8 on the IVF probe (1 q x {rows.numel()} "
                f"gathered rows, nprobe 8 of {ivf.n_clusters} clusters, "
                f"bucket {ivf.bucket}, {POOL} pool): kernel {probe_ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                f"{b_ms / probe_ms:.1%} of it reached) [{card}]")
        eng._calls.drop()             # each path captured here, afresh
        for label, fn in (
                (f"IVF {pd} 1 q nprobe 8", lambda: eng.query_ivf(
                    q[:1], k=K, nprobe=8)),
                (f"coarse {pd} 1 q T={IVF_TOKENS} S={IVF_SHORTLIST}",
                 lambda: ivf.query_coarse(q[:1], k=K,
                                          shortlist=IVF_SHORTLIST))):
            def on(flag, fn=fn):
                def call():
                    eng.scan_chunks = flag
                    return fn()
                return call
            graphed_vs_eager(f"{label} at {eng.pool_size} (topic pool)",
                             eng._calls, on(True), on(False), 20, card)
        eng.scan_chunks = True
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


def run_cli(argv) -> list:
    """``cli.main(argv)`` in this process; returns its stdout lines (the
    trec_eval tables stay off the smoke's own output)."""
    import contextlib
    import io

    from mms_answer_selection_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    return out.getvalue().splitlines()


def stream_vs_fit_steps(model, tcfg, splits, info, mmsp, dev, card) -> None:
    """Step p50 at batch 50 on the corpus: the packed store's ring through
    ``next_device`` (pinned staging, non-blocking copies) against ``fit``'s
    device-side batch stream, each step ended by a device sync."""
    from mms_answer_selection_tpu_torch.native import (
        NativePrefetcher, PackedStore)
    from mms_answer_selection_tpu_torch.training import Trainer

    tr = Trainer(model, tcfg, device=dev)
    p, s, o = tr.init(pretrained=info["pretrained"])
    ring = NativePrefetcher(PackedStore(mmsp), ["question", "answer",
                                                "label", "overlap_feat"],
                            tcfg.batch_size, seed=tcfg.seed)
    train = tr._full_batch({k: v for k, v in splits["train"].items()
                            if k != "group"})
    epoch = iter(tr._epoch_batches(train, 0))

    def stream_step():
        b = ring.next_device(dev)
        b["label"] = b["label"][:, 0]
        tr._train_step(p, s, o, b, 0)

    def fit_step():
        tr._train_step(p, s, o, next(epoch), 0)

    t = [sync_ms(fit_step, STREAM_STEP_REPS),
         sync_ms(stream_step, STREAM_STEP_REPS),
         sync_ms(stream_step, STREAM_STEP_REPS),
         sync_ms(fit_step, STREAM_STEP_REPS)]
    log(f"time train step batch {tcfg.batch_size}: train --stream (packed "
        f"store, next_device) p50 {(t[1] + t[2]) / 2:.3f} ms, fit p50 "
        f"{(t[0] + t[3]) / 2:.3f} ms [turns {[round(x, 3) for x in t]}; "
        f"{card}]")
    ring.close()


def http_json(base: str, path: str, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def same_reply(reply, vals, idx, what: str, atol: float = 0.0) -> None:
    """A /query reply against the engine's (vals, idx): the same candidates
    and scores (exact, or within ``atol`` for the rerank's P)."""
    vals, idx = vals.cpu().tolist(), idx.cpu().tolist()
    got = [r["topk"] for r in reply["results"]]
    for g, v, i in zip(got, vals, idx, strict=True):
        if [c for c, _ in g] != i or any(
                abs(x - y) > atol for (_, x), y in zip(g, v, strict=True)):
            raise AssertionError(f"{what}: the server's reply differs from "
                                 f"the engine's")


def cli_phase(dev, card: str) -> dict:
    """The path a user takes, through ``cli.main`` at V4's widths on the
    recipe-sized corpus: ``prep --mmsp``; ``train --stream`` to step 200
    with snapshots every 100, ``--resume`` to 400, beside an uninterrupted
    400-step run (a xavier W, held to each other), the same three runs
    from the recipe's W = 0 (read against each other, not held); ``eval``
    of the best checkpoint; an int8 index of POOL candidates from it
    behind ``serve --int8 --index --listen 0``, its /query (1 q, 32 q,
    rerank 50), /add, /remove and /compact against the engine; the server
    stopped through the module hook.  The launches are counted in two
    windows, each held to its kernels: prep to eval, and the HTTP requests
    alone.  Returns both counts."""
    import dataclasses
    import tempfile
    import threading

    import numpy as np

    from mms_answer_selection_tpu_torch import cli
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.data import load_dataset
    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.serve import QueryEngine
    from mms_answer_selection_tpu_torch.training import Trainer
    from mms_answer_selection_tpu_torch.training.checkpoint import (
        latest_checkpoint, load_checkpoint, save_checkpoint)
    from mms_answer_selection_tpu_torch.utils.config import (
        experiment_to_json)

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    xmls, w2v = recipe_xml(D)
    for name, xml in zip(("train", "dev", "test"), xmls):
        (root / f"{name}.xml").write_text(xml)
    with open(root / "glove.txt", "w") as f:
        for w, v in w2v.items():
            f.write(w + " " + " ".join(map(repr, v)) + "\n")
    corpus_s = time.perf_counter() - t0
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    started = time.perf_counter()
    prep = root / "prep"
    run_cli(["prep", "--train-xml", str(root / "train.xml"), "--dev-xml",
             str(root / "dev.xml"), "--test-xml", str(root / "test.xml"),
             "--glove", str(root / "glove.txt"), "--out", str(prep),
             "--mmsp"])
    prep_s = time.perf_counter() - started
    meta = json.loads((prep / "meta.json").read_text())
    recipe = dataclasses.replace(V4, vocab_size=meta["vocab_size"])
    model = dataclasses.replace(recipe, sim_weight_init="xavier")
    tcfg = dataclasses.replace(recipe_trainer(), max_iter=CLI_STEPS,
                               snapshot_interval=SNAP_EVERY,
                               test_interval=SNAP_EVERY)
    exps = {}
    for name, cfg in (("full", model), ("part", model),
                      ("zero_full", recipe), ("zero_part", recipe)):
        exps[name] = root / name
        exps[name].mkdir()
        (exps[name] / "cfg.json").write_text(experiment_to_json(
            cfg, dataclasses.replace(
                tcfg, snapshot_dir=str(exps[name] / "models"))))

    def train(name, *extra):
        t = time.perf_counter()
        run_cli(["train", "--data", str(prep), "--exp", str(exps[name]),
                 "--config", str(exps[name] / "cfg.json"), "--stream",
                 "--device", "cuda", *extra])
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def resumed_vs_full(part, full):
        """Runs ``part`` (interrupted, resumed) and ``full``: their
        histories (each checked for its evals, a falling loss and dev
        MAPs in [0, 1]), the max abs dev-MAP difference, and the step
        CLI_STEPS - 1 params' max difference relative to each leaf's max
        |value| (conv biases apart) with its leaf."""
        hist = {n: json.loads((exps[n] / "history.json").read_text())
                for n in (part, full)}
        for n, h in hist.items():
            losses = np.asarray(h["train_loss"])
            if h["steps"] != list(range(0, CLI_STEPS, SNAP_EVERY)):
                raise AssertionError(f"train --stream {n} evaluated at "
                                     f"{h['steps']}")
            if not np.isfinite(losses).all() \
                    or not losses[-5:].mean() < losses[0]:
                raise AssertionError(f"cli train {n}: the loss did not "
                                     f"fall: {losses}")
            if not all(0.0 <= m <= 1.0 for m in h["dev_map"]):
                raise AssertionError(f"cli train {n}: dev MAP {h['dev_map']}")
        map_diff = float(np.abs(np.subtract(hist[part]["dev_map"],
                                            hist[full]["dev_map"])).max())
        last = f"models/qa_iter_{CLI_STEPS - 1}"
        a, _ = load_checkpoint(str(exps[full] / last))
        b, _ = load_checkpoint(str(exps[part] / last))
        worst, where = 0.0, ""
        for name, sub in a["params"].items():
            for k, want in sub.items():
                if name.startswith("conv") and k == "b":
                    continue
                rel = float(np.abs(b["params"][name][k] - want).max()
                            / np.abs(want).max())
                if rel > worst:
                    worst, where = rel, f"{name}.{k}"
        return hist, map_diff, worst, where

    def curve(h):
        return (f"loss {h['train_loss'][0]:.4f} -> "
                f"{np.mean(h['train_loss'][-5:]):.4f}, dev MAP "
                f"{[round(x, 4) for x in h['dev_map']]}")

    t_part = train("part", "--max-iter", str(CLI_SPLIT))
    t_resume = train("part", "--resume")
    t_full = train("full")
    hist, map_diff, worst, where = resumed_vs_full("part", "full")
    log(f"cli train --stream: {CLI_SPLIT} steps ({t_part:.3f} s), --resume "
        f"to {CLI_STEPS} ({t_resume:.3f} s), uninterrupted {CLI_STEPS} "
        f"({t_full:.3f} s); prep --mmsp {prep_s:.3f} s (corpus written in "
        f"{corpus_s:.3f} s); uninterrupted {curve(hist['full'])}; resumed "
        f"dev MAP {[round(x, 4) for x in hist['part']['dev_map']]}: max abs "
        f"diff {map_diff:.3e} (tol {RESUME_MAP_ATOL:g}); step "
        f"{CLI_STEPS - 1} params max rel diff {worst:.3e} at {where} (tol "
        f"{RESUME_PARAM_RTOL:g}, conv biases apart) [{card}]")
    if map_diff > RESUME_MAP_ATOL or worst > RESUME_PARAM_RTOL:
        raise AssertionError("a resumed train --stream run parts from the "
                             "uninterrupted one")

    # the recipe's own W = 0 through the same commands: from it two card
    # runs part at step 0 (near-tied first scores), so the resumed run is
    # read against the uninterrupted one, not held to it
    t0 = time.perf_counter()
    train("zero_part", "--max-iter", str(CLI_SPLIT))
    train("zero_part", "--resume")
    train("zero_full")
    zero, map_diff, worst, where = resumed_vs_full("zero_part", "zero_full")
    log(f"cli train --stream, the recipe's W = 0 ({CLI_SPLIT} + --resume "
        f"and {CLI_STEPS} uninterrupted, {time.perf_counter() - t0:.3f} s): "
        f"uninterrupted {curve(zero['zero_full'])}; resumed "
        f"{curve(zero['zero_part'])}; dev MAP max abs diff {map_diff:.3e}, "
        f"step {CLI_STEPS - 1} params max rel diff {worst:.3e} at "
        f"{where or '-'} (read, not held) [{card}]")

    # ------------------------------------------------------------- eval
    ev = json.loads(run_cli(["eval", "--data", str(prep), "--exp",
                             str(exps["full"]), "--device", "cuda"])[-1])
    log(f"cli eval (best_iter_{hist['full']['best_step']}, test split): "
        f"trec_eval MAP {ev['trec_map']:.6f} MRR {ev['trec_mrr']:.6f}, "
        f"in-graph MAP {ev['in_graph_map']:.6f} MRR "
        f"{ev['in_graph_mrr']:.6f}")
    if abs(ev["trec_map"] - ev["in_graph_map"]) > 1e-6 \
            or abs(ev["trec_mrr"] - ev["in_graph_mrr"]) > 1e-6:
        raise AssertionError("cli eval: trec_eval disagrees with the "
                             "in-graph metrics")
    trained = dict(sk.LAUNCH_COUNTS)
    log(f"launches of prep, train --stream, --resume and eval: {trained}; "
        f"{time.perf_counter() - started:.1f} s")
    for name in CLI_TRAIN_KERNELS:
        if trained[name] < 1:
            raise AssertionError(f"the CLI's training never launched {name}")

    # ------------------------------------------------------------ serve
    splits = {n: load_dataset(str(prep / f"{n}.npz"))
              for n in ("train", "dev", "test")}
    best = latest_checkpoint(str(exps["full"]), prefix="best")
    bundle, _ = load_checkpoint(best)
    params, state = params_from_numpy(bundle["params"], bundle["state"], dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    answers = torch.as_tensor(splits["train"]["answer"], device=dev)
    cand = torch.cat([answers, torch.randint(
        0, model.vocab_size, (POOL - len(answers), W2), generator=gen,
        device=dev, dtype=answers.dtype)])
    engine = QueryEngine(params, model, pool_dtype="int8", chunk_size=CHUNK,
                         device=dev).build_index(cand)
    index = str(root / "pool.npz")
    engine.save_index(index)
    cli._LAST_SERVER = None
    th = threading.Thread(target=cli.main, args=([
        "serve", "--data", str(prep), "--exp", str(exps["full"]), "--int8",
        "--index", index, "--listen", "0", "--device", "cuda"],),
        daemon=True)
    th.start()
    for _ in range(1200):
        if cli._LAST_SERVER is not None or not th.is_alive():
            break
        time.sleep(0.05)
    srv = cli._LAST_SERVER
    if srv is None:
        raise AssertionError("serve --listen never came up")
    base = f"http://{srv.host}:{srv.port}"
    served = dict.fromkeys(sk.LAUNCH_COUNTS, 0)

    def request(path, payload=None):
        """One HTTP request; the launches made while it was answered join
        ``served`` (this process calls the engine only between
        requests)."""
        before = dict(sk.LAUNCH_COUNTS)
        reply = http_json(base, path, payload)
        for name, n in sk.LAUNCH_COUNTS.items():
            served[name] += n - before[name]
        return reply

    try:
        health = request("/healthz")
        if health["pool"] != POOL or health["pool_dtype"] != "int8":
            raise AssertionError(f"serve --index: {health}")
        q_all = torch.as_tensor(splits["test"]["question"][:32], device=dev)
        timed, direct, timed_want = {}, {}, {}
        for nq in (1, 32):
            q = q_all[:nq]
            timed_want[nq] = engine.query(q, k=K)
            for rerank in (0, SHORTLIST):
                req = {"tokens": q.tolist(), "k": K, "rerank": rerank}
                reply = request("/query", req)
                if rerank:
                    same_reply(reply, *engine.query_rerank(
                        state, q, k=K, shortlist=rerank),
                        f"/query {nq} q rerank {rerank}", atol=1e-6)
                else:
                    same_reply(reply, *engine.query(q, k=K),
                               f"/query {nq} q")
                times = []
                for _ in range(HTTP_REPS):
                    t = time.perf_counter()
                    request("/query", req)
                    times.append((time.perf_counter() - t) * 1e3)
                timed[nq, rerank] = statistics.median(times)
                # the same call on the engine in this process, results
                # fetched to the host as the server fetches them
                call = (lambda: engine.query_rerank(
                    state, q, k=K, shortlist=rerank)) if rerank else (
                    lambda: engine.query(q, k=K))
                direct[nq, rerank] = sync_ms(
                    lambda: [t.cpu() for t in call()], HTTP_REPS)
        # one dispatch over HTTP: a batch the server pads (3 rows to the
        # bucket of 4) answers as the engine does unpadded; the server's
        # engine eager (scan_chunks off) against graph replays, in turns
        same_reply(request("/query", {"tokens": q_all[:3].tolist(),
                                      "k": K}),
                   *engine.query(q_all[:3], k=K), "/query 3 q (padded)")
        http = {}
        for nq in (1, 32):
            req = {"tokens": q_all[:nq].tolist(), "k": K}
            turns = {"eager": [], "replay": []}
            for mode in ("eager", "replay", "replay", "eager"):
                srv.engine.scan_chunks = mode == "replay"
                # warm (a replay's capture), held to the engine
                same_reply(request("/query", req), *timed_want[nq],
                           f"/query {nq} q {mode}")
                times = []
                for _ in range(HTTP_REPS):
                    t = time.perf_counter()
                    request("/query", req)
                    times.append((time.perf_counter() - t) * 1e3)
                turns[mode].append(statistics.median(times))
            http[nq] = turns
        srv.engine.scan_chunks = True
        log(f"dispatch HTTP /query through serve --listen (int8, {POOL} "
            f"candidates, pad_buckets on): " + ", ".join(
                f"{nq} q eager p50 {sum(t['eager']) / 2:.3f} ms, replay p50 "
                f"{sum(t['replay']) / 2:.3f} ms (turns "
                f"{({m: [round(x, 3) for x in v] for m, v in t.items()})})"
                for nq, t in http.items())
            + f" ({HTTP_REPS} requests a turn); a 3-q batch padded to 4 "
            f"answers as the engine [{card}]")
        added = request("/add", {"tokens": cand[:3].tolist()})
        if added["added"] != engine.add_candidates(cand[:3]).tolist():
            raise AssertionError("/add differs from the engine")
        dead = [0, 5, POOL + 1]
        removed = request("/remove", {"rows": dead})
        engine.remove_candidates(dead)
        if removed["n_live"] != engine.n_live:
            raise AssertionError("/remove differs from the engine")
        same_reply(request("/query", {"tokens": q_all[:4].tolist(),
                                      "k": K}),
                   *engine.query(q_all[:4], k=K), "/query after /remove")
        compacted = request("/compact", {})
        mapping = engine.compact()
        if compacted["pool"] != engine.pool_size \
                or compacted["reclaimed"] != int((mapping < 0).sum()):
            raise AssertionError("/compact differs from the engine")
        same_reply(request("/query", {"tokens": q_all[:4].tolist(),
                                      "k": K}),
                   *engine.query(q_all[:4], k=K), "/query after /compact")
    finally:
        srv.httpd.shutdown()            # the module hook stops the server
        th.join(timeout=60)
    if th.is_alive():
        raise AssertionError("serve --listen did not stop")
    log(f"launches of serve --int8 --index --listen while it answered "
        f"HTTP requests (the engine it is held to apart): {served}; "
        f"{time.perf_counter() - started:.1f} s since prep")
    for name in CLI_SERVE_KERNELS:
        if served[name] < 1:
            raise AssertionError(f"serve never launched {name}")
    log(f"cli serve --int8 --index ({POOL} candidates, loaded from the "
        f"saved index) over HTTP, /query p50 (the engine called in-process): "
        + ", ".join(f"{nq} q{f' rerank {r}' if r else ''} "
                    f"{timed[nq, r]:.3f} ms ({direct[nq, r]:.3f})"
                    for nq, r in timed)
        + f" ({HTTP_REPS} requests each); replies = the engine's; /add, "
        f"/remove, /compact = the engine's [{card}]")

    # --------------------------------------------- snapshot and step times
    tr = Trainer(model, tcfg, device=dev)
    p, s, o = tr.init(pretrained=np.load(prep / "vocab.npz")["pretrained"])
    torch.cuda.synchronize()
    snap_ms = sync_ms(lambda: save_checkpoint(
        str(root / "timed"), 0, {"params": p, "state": s, "opt_state": o}),
        5)
    size = (root / "timed" / "qa_iter_0" / "ckpt.msgpack").stat().st_size
    log(f"time snapshot (V4 params + BN state + AdaDelta state, "
        f"{size / 2**20:.3f} MiB, card to ckpt.msgpack): p50 {snap_ms:.3f} ms"
        f" [{card}]")
    stream_vs_fit_steps(model, tcfg, splits, {"pretrained": np.load(
        prep / "vocab.npz")["pretrained"]}, str(prep / "train.mmsp"), dev,
        card)

    del engine, srv
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"train": trained, "serve": served}


def graph_files(root: Path, vocab: int, *, xavier: bool, still: bool = False,
                batch: int = BATCH, test: bool = True,
                solver_type: str = "adadelta") -> str:
    """The V4 recipe's own nets as NetParameter text from
    ``net_prototxt_from_config`` at V4's widths and ``vocab`` (the train
    net, and the eval net with the MAP / MRR / AUC layers) and its solver
    prototxt from ``solver_prototxt_from_config`` (AdaDelta, snapshots and
    dev tests every GRAPH_EVERY steps), written into ``root``; returns the
    solver's path.  The eval net's data layer is named "dev", so one
    ``feeds=`` dict feeds both nets.  ``xavier`` gives SimCross a xavier
    weight filler in place of the recipe's constant 0; ``still`` leaves
    out the dropout layers (the card's and the CPU's generators draw
    different masks)."""
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.training import SolverConfig
    from mms_answer_selection_tpu_torch.utils.prototxt import (
        net_prototxt_from_config, solver_prototxt_from_config,
        trainer_config_from_prototxt)

    cfg = dataclasses.replace(V4, vocab_size=vocab)
    if still:
        cfg = dataclasses.replace(cfg, sim_dropout=0.0, fc1_dropout=0.0)
    nets = {"train": net_prototxt_from_config(cfg, batch_size=batch),
            "eval": net_prototxt_from_config(cfg, phase="eval").replace(
                'name: "data"', 'name: "dev"', 1)}
    for name, text in nets.items():
        if xavier:
            text = text.replace("sim_cross_param {", 'sim_cross_param { '
                                'weight_filler { type: "xavier" }', 1)
        (root / f"{name}.prototxt").write_text(text)
    solver = recipe_trainer().solver if solver_type == "adadelta" else \
        SolverConfig(solver_type=solver_type, base_lr=0.1, momentum=0.9,
                     weight_decay=5e-4)
    tcfg = dataclasses.replace(
        recipe_trainer(), max_iter=GRAPH_STEPS, test_interval=GRAPH_EVERY,
        snapshot_interval=GRAPH_EVERY, display=0,
        snapshot_prefix=str(root / "v4"),
        solver=dataclasses.replace(solver, max_iter=GRAPH_STEPS))
    text = solver_prototxt_from_config(
        tcfg, train_net="train.prototxt",
        test_net="eval.prototxt" if test else None)
    back = trainer_config_from_prototxt(text)
    if back.solver != tcfg.solver or back.max_iter != GRAPH_STEPS:
        raise AssertionError(f"the solver prototxt reads back as {back}")
    (root / "solver.prototxt").write_text(text)
    return str(root / "solver.prototxt")


def graph_feeds(splits, batch: int = BATCH) -> dict:
    """``feeds=`` for the recipe's nets: the train split in shuffled
    batches for "data", the whole dev split as one test batch for "dev"."""
    keys = ("question", "answer", "label", "overlap_feat")
    dev = splits["dev"]
    return {"data": {**{k: splits["train"][k] for k in keys},
                     "batch_size": batch},
            "dev": {**{k: dev[k] for k in keys + ("group",)},
                    "batch_size": len(dev["label"]), "shuffle": False}}


GRAPH_NAME_MAP = {"w2v_q": "embed", "sim_cross": "sim", "conv0": "conv0",
                  "bn0": "bn0", "conv1": "conv1", "bn1": "bn1",
                  "fc1": "fc1", "fc2": "fc2"}


def graph_params_close(got, want, band=None) -> tuple[float, str]:
    """Each param leaf of ``got`` against ``want`` (both on the CPU):
    (worst max abs diff over the leaf's max |value|, its leaf).  The conv
    biases are rounding noise under train-mode BN: held to ``band``
    instead, or left out where ``band`` is None."""
    worst, where = 0.0, ""
    for name, sub in want.items():
        for k, w in sub.items():
            diff = float((got[name][k] - w).abs().max())
            if name.startswith("conv") and k == "b":
                if band is not None and diff > band:
                    raise AssertionError(f"{name}.{k} moved {diff:.3e} apart,"
                                         f" past the band {band:.3e}")
                continue
            rel = diff / max(float(w.abs().max()), 1e-30)
            if rel > worst:
                worst, where = rel, f"{name}.{k}"
    return worst, where


def nettest_replays(dev, card: str, main_dir: Path, model_path: Path,
                    dev_arrays, nt: dict) -> None:
    """``nettest``'s and ``extract_features``' iterations (the CLI's
    bodies, ``cli._nettest_forward`` / ``_features_forward``, on the last
    snapshot and the dev split) as replays against direct calls: equal bit
    for bit, timed in turns; the ``nettest`` CLI's MAP (``nt``, its
    replays) = the eager call's, and ``extract_features`` through the CLI
    (two iterations) = the eager body's blobs, bit for bit."""
    import numpy as np

    from mms_answer_selection_tpu_torch import cli as tcli
    from mms_answer_selection_tpu_torch.data import hdf5_compat
    from mms_answer_selection_tpu_torch.models.graph_net import (
        DATA_TYPES, GraphNet)
    from mms_answer_selection_tpu_torch.utils.caffemodel import (
        load_caffemodel_auto)
    from mms_answer_selection_tpu_torch.utils.graphs import (
        GraphedCall, on_device)
    from mms_answer_selection_tpu_torch.utils.seed import derive_seed

    model = main_dir / "nettest.prototxt"
    net = GraphNet(model.read_text(), phase="test")
    arrays = dev_arrays(None)
    batch = {t: torch.as_tensor(arrays[t]) for n in net.layers
             if n.type in DATA_TYPES for t in n.tops}
    params, state = net.init(torch.Generator().manual_seed(0),
                             on_device(batch, dev), device=dev)
    params, state, _ = load_caffemodel_auto(
        str(model_path), params, state,
        specs=net.caffemodel_specs(params, state))
    body = tcli._nettest_forward(net, params, state)
    calls = GraphedCall(dev, name="nettest")
    n = len(arrays["label"])
    want, _ = graphed_vs_eager(
        f"nettest iteration (V4 eval net, dev split {n} pairs)", calls,
        lambda: calls(("nettest",), body, batch, fixed=(params, state)),
        lambda: torch.no_grad()(body)(on_device(batch, dev)), 20, card)
    if float(want["map"]) != nt["map"]:
        raise AssertionError(f"the nettest CLI's MAP {nt['map']} differs "
                             f"from the eager call's {float(want['map'])}")

    blobs = ["prob", "sim_cross"]
    fbody = tcli._features_forward(net, params, state, blobs)
    fcalls = GraphedCall(dev, name="extract_features")
    seed = derive_seed(0, 0xFEA7, 0)

    @torch.no_grad()
    def features_eager():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return fbody(on_device(batch, dev), generators=[gen])

    feats, _ = graphed_vs_eager(
        f"extract_features iteration (V4 eval net, blobs {blobs}, dev "
        f"split {n} pairs)", fcalls,
        lambda: fcalls(("extract_features",), fbody, batch,
                       fixed=(params, state), generators=(seed,)),
        features_eager, 20, card)
    real = hdf5_compat.load_hdf5_list
    hdf5_compat.load_hdf5_list = dev_arrays
    try:
        run_cli(["extract_features", "--model", str(model), "--weights",
                 str(model_path), "--blobs", ",".join(blobs),
                 "--iterations", "2", "--out", str(main_dir / "feats"),
                 "--device", "cuda"])
    finally:
        hdf5_compat.load_hdf5_list = real
    for b in blobs:
        got = np.load(main_dir / "feats" / f"{b}.npy")
        one = feats[b].cpu().numpy()
        if not np.array_equal(got, np.concatenate([one, one])):
            raise AssertionError(f"extract_features' {b} differs from the "
                                 f"eager body's")
    log(f"cli extract_features --blobs {','.join(blobs)} --iterations 2 "
        f"(two replays) = the eager body's blobs, bit for bit [{card}]")


def generic_step_replays(dev, card: str, root: Path, vocab: int,
                         splits) -> None:
    """A GraphSolver step as one replay against the eager ``_train_step``,
    bit for bit, at each GRAPH_CHECK (batch, iter_size): two solvers from
    one solver prototxt (the recipe's nets with dropout, a xavier W),
    GRAPH_CHECK_STEPS iterations each, the replayed one through ``step``,
    under deterministic algorithms (two eager steps part in the last bits
    otherwise).  Fails unless the losses and every leaf of the params, BN
    state and solver history are equal and each iteration was one
    replay."""
    from mms_answer_selection_tpu_torch.training.graph_solver import (
        GraphSolver)

    for bsz, iter_size in GRAPH_CHECK:
        pair = []
        for side in ("replay", "eager"):
            d = root / f"check_{bsz}_{iter_size}_{side}"
            d.mkdir()
            path = Path(graph_files(d, vocab, xavier=True, batch=bsz,
                                    test=False))
            path.write_text(path.read_text() + f"iter_size: {iter_size}\n")
            pair.append(GraphSolver(str(path), feeds=graph_feeds(splits, bsz),
                                    device=dev))
        a, b = pair
        got, want = [], []
        with deterministic_algorithms():
            for _ in range(GRAPH_CHECK_STEPS):
                a.step(1)              # one iteration: _smoothed = its loss
                got.append(a._smoothed)
                want.append(float(b._train_step()[0]))
                b.iter_ += 1
        la, lb = solver_leaves(a), solver_leaves(b)
        unequal = [k for k in lb if not torch.equal(la[k], lb[k])]
        log(f"check GraphSolver step replay vs eager _train_step (V4 recipe "
            f"nets with dropout, xavier W, batch {bsz}, iter_size "
            f"{iter_size}, {GRAPH_CHECK_STEPS} iterations, deterministic "
            f"algorithms): losses {got} vs {want}; {len(lb) - len(unequal)} "
            f"of {len(lb)} leaves equal bit for bit; {a.runner.replays} "
            f"replays, a replay launches {a.runner.stats()[0]['tally']}")
        if got != want or unequal or a.runner.replays != GRAPH_CHECK_STEPS:
            raise AssertionError(f"a replayed GraphSolver step differs from "
                                 f"the eager one: {unequal}")
        del a, b, pair


def graph_phase(dev, card: str, splits, info) -> dict:
    """The reference's own workflow on the port: the V4 recipe's train and
    eval nets as NetParameter text, an AdaDelta solver prototxt beside
    them, ``GraphSolver`` on the card over the recipe-sized corpus
    (``feeds=``, dev tests with the eval net's MAP / MRR / AUC layers,
    BINARYPROTO snapshots), ``restore`` from a ``.solverstate``,
    ``nettest`` and ``train --weights`` on the last ``.caffemodel``.  It
    fails unless (1) the generic train net's fc2 equals the typed model's
    logits on the same weights, (2) a generic step on the card equals the
    same step on the CPU after an SGD warm start from a xavier W, (3) the
    recipe's solve launches the three pair-map kernels and its test net
    the forward, its dev loss falls and the MAP / MRR layers equal the
    in-process metrics, (4) a run snapshotted and restored at
    GRAPH_RESUME_AT equals the uninterrupted one from a xavier W, (5)
    ``nettest`` prints the MAP of the solver's last test pass and ``train
    --weights`` loads the .caffemodel into the typed ``Trainer``.  Times
    the generic step against the typed one (batch 50 and 1024, in turns),
    one snapshot and ``nettest``.  Returns the solve's launches."""
    import dataclasses
    import logging
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch.data import hdf5_compat
    from mms_answer_selection_tpu_torch.metrics import (
        mean_average_precision, mean_reciprocal_rank)
    from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        V4, mms_qa_apply, mms_qa_init)
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.training import Trainer
    from mms_answer_selection_tpu_torch.training.graph_solver import (
        GraphSolver)
    from mms_answer_selection_tpu_torch.utils.prototxt import (
        net_prototxt_from_config)
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    vocab = info["vocab_size"]
    feeds = graph_feeds(splits)
    cpu = torch.device("cpu")

    def to(tree, where):
        return tree_map(lambda t: t.to(where), tree)

    # --------------------------- (1) generic forward = typed forward
    still = dataclasses.replace(V4, vocab_size=vocab, sim_dropout=0.0,
                                fc1_dropout=0.0, sim_weight_init="xavier")
    tp, ts = mms_qa_init(still, generator=torch.Generator().manual_seed(SEED),
                         device=dev)
    net = GraphNet(net_prototxt_from_config(still), phase="train")
    batch = {k: torch.as_tensor(v[:BATCH], device=dev)
             for k, v in splits["train"].items() if k != "group"}
    gp, gs0 = net.init(torch.Generator(), batch, device=dev)
    shapes = {g: {k: tuple(v.shape) for k, v in gp[g].items()}
              for g in gp}
    gp = {g: tp[t] for g, t in GRAPH_NAME_MAP.items()}
    if {g: {k: tuple(v.shape) for k, v in gp[g].items()} for g in gp} \
            != shapes or set(gs0) != {"bn0", "bn1"}:
        raise AssertionError("the generic V4 tree differs from the typed")
    with torch.no_grad():
        blobs, _ = net.apply(gp, {"bn0": ts["bn0"], "bn1": ts["bn1"]}, batch,
                             train=True)
        out, _ = mms_qa_apply(tp, ts, batch, still, train=True,
                              generator=torch.Generator(device=dev))
    err = float((blobs["fc2"] - out["logits"]).abs().max())
    rel = err / float(out["logits"].abs().max())
    log(f"check generic V4 train net vs typed mms_qa_apply (batch {BATCH}, "
        f"the typed weights carried over, train-mode BN): fc2 max abs err "
        f"{err:.3e}, {rel:.3e} of its max (tol 1e-5); loss "
        f"{float(blobs['loss']):.6f} vs {float(out['loss']):.6f}")
    if rel > 1e-5:
        raise AssertionError("the generic V4 net's fc2 differs from the "
                             "typed model's logits")
    del tp, ts, gp, gs0, net

    # ---------------------------------------- (2) card = CPU, one step
    warm_dir, step_dir = root / "warm", root / "step"
    warm_dir.mkdir()
    step_dir.mkdir()
    warm = GraphSolver(graph_files(warm_dir, vocab, xavier=True, still=True,
                                   test=False, solver_type="sgd"),
                       feeds=feeds, device=cpu)
    warm.step(GRAPH_WARM_STEPS)
    solver = graph_files(step_dir, vocab, xavier=True, still=True,
                         test=False)
    stepped = []
    for where in (cpu, dev):
        g = GraphSolver(solver, feeds=feeds, device=where)
        g.params, g.state = to(warm.params, where), to(warm.state, where)
        g.opt_state = g.solver.init(g.params)
        loss, _ = g._train_step()
        stepped.append((float(loss), to(g.params, cpu)))
    (c_loss, c_p), (g_loss, g_p) = stepped
    loss_rel = abs(g_loss / c_loss - 1)
    worst, where = graph_params_close(g_p, c_p, 2 * 2 * ADADELTA_STEP)
    log(f"check GraphSolver step card vs CPU (V4 recipe net without its "
        f"dropout, batch {BATCH}, AdaDelta after {GRAPH_WARM_STEPS} SGD "
        f"steps from a xavier W): "
        f"loss {g_loss:.6f}, rel err {loss_rel:.3e} (tol 1e-5); params max "
        f"diff {worst:.3e} of the leaf's max at {where} (tol 1e-4; conv "
        f"biases within {2 * 2 * ADADELTA_STEP:.3e})")
    if loss_rel > 1e-5 or worst > 1e-4:
        raise AssertionError("a GraphSolver step differs between card and "
                             "CPU")
    del warm, stepped, g

    # ------------------------- (3) the recipe's solve, its launches
    main_dir = root / "recipe"
    main_dir.mkdir()
    gs = GraphSolver(graph_files(main_dir, vocab, xavier=False),
                     feeds=feeds, device=dev)
    losses = []
    gs.callbacks.append((lambda: None, lambda: losses.append(
        float(gs.last_outs["loss"]))))
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    gs.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCH_COUNTS)
    log(f"launches on the generic path (GraphSolver.solve, {GRAPH_STEPS} "
        f"steps with {GRAPH_STEPS // GRAPH_EVERY + 1} dev tests): "
        f"{launches}")
    for name in CLI_TRAIN_KERNELS:
        if launches[name] < GRAPH_STEPS:
            raise AssertionError(f"the generic path launched {name} "
                                 f"{launches[name]} times")
    tests = [r for r in gs.history if r["phase"] == "Test#0"]
    if [r["iter"] for r in tests] != list(range(0, GRAPH_STEPS + 1,
                                                GRAPH_EVERY)):
        raise AssertionError(f"dev tests at {[r['iter'] for r in tests]}")
    window = max(1, GRAPH_STEPS // 15)
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    if not np.isfinite(losses).all() or not last < first \
            or not all(0 <= r["map"] <= 1 for r in tests):
        raise AssertionError(f"the train loss did not fall ({first} -> "
                             f"{last}) or a dev MAP is out of [0, 1]: "
                             f"{tests}")
    before = dict(sk.LAUNCH_COUNTS)
    res = gs.test()
    torch.cuda.synchronize()
    test_launch = {k: sk.LAUNCH_COUNTS[k] - before[k] for k in before}
    if test_launch["pair_maps_fwd"] < 1 or test_launch["pair_maps_bwd_w"] \
            or test_launch["pair_maps_bwd_qa"]:
        raise AssertionError(f"a test pass launched {test_launch}")
    p, s = gs._shared_test_trees(0)
    dev_split = splits["dev"]
    with torch.no_grad():
        b, _ = gs.test_nets[0].apply(p, s, {k: torch.as_tensor(
            dev_split[k], device=dev) for k in feeds["dev"]
            if k not in ("batch_size", "shuffle")})
    scores = b["prob"][:, 1].double().cpu().numpy()
    np_map = mean_average_precision(scores, dev_split["label"],
                                    dev_split["group"])
    np_mrr = mean_reciprocal_rank(scores, dev_split["label"],
                                  dev_split["group"])
    log(f"GraphSolver.solve (the recipe's W = 0, batch {BATCH}): "
        f"{GRAPH_STEPS} steps in {solve_s:.3f} s, train loss {first:.4f} -> "
        f"{last:.4f} (means of the first and last {window}), dev loss "
        f"{[round(r['loss'], 4) for r in tests]}, dev MAP "
        f"{[round(r['map'], 4) for r in tests]}, MRR "
        f"{[round(r['mrr'], 4) for r in tests]} at "
        f"{[r['iter'] for r in tests]}; a test pass launched {test_launch}; "
        f"MAP layer {float(res['map']):.6f} vs in-process {np_map:.6f}, MRR "
        f"layer {float(res['mrr']):.6f} vs {np_mrr:.6f} (tol 1e-6) [{card}]")
    if abs(float(res["map"]) - np_map) > 1e-6 \
            or abs(float(res["mrr"]) - np_mrr) > 1e-6:
        raise AssertionError("the MAP / MRR layers disagree with the "
                             "in-process metrics")
    # every test batch was one replay; a pass through the graph = the
    # eager pass, bit for bit, and one batch of each timed
    passes = len(tests) + 1
    (test_key,) = gs.forwards.stats()
    got_t = gs._test_means(0, gs._test_outputs)
    want_t = gs._test_means(0, gs._test_outputs_eager)
    log(f"GraphSolver test passes: {test_key['replays']} replays of one "
        f"graph over {passes} passes of {gs.test_iters[0]} batch; a pass "
        f"replayed {({k: float(v) for k, v in got_t.items()})} = eager "
        f"{({k: float(v) for k, v in want_t.items()})}")
    if test_key["replays"] != passes * gs.test_iters[0] \
            or got_t.keys() != want_t.keys() \
            or any(not np.array_equal(got_t[k], want_t[k]) for k in want_t):
        raise AssertionError("a GraphSolver test pass: not one replay a "
                             "batch, or the replay differs from the eager "
                             "pass")
    tp_, ts_ = gs._shared_test_trees(0)
    tbatch = gs._host_batch(gs._test_feeds[0])
    gs.forwards.drop()
    graphed_vs_eager(
        f"GraphSolver test batch (V4 eval net, dev split "
        f"{len(dev_split['label'])} pairs)", gs.forwards,
        lambda: gs._test_outputs(0, tp_, ts_, tbatch, 7),
        lambda: gs._test_outputs_eager(0, tp_, ts_, tbatch, 7), 20, card)

    # ------------------------------- (5) nettest and train --weights
    model_path = main_dir / f"v4_iter_{GRAPH_STEPS}.caffemodel"
    if not model_path.exists() or not (
            main_dir / f"v4_iter_{GRAPH_STEPS}.solverstate").exists():
        raise AssertionError(f"no snapshot at {GRAPH_STEPS}")

    # the card host has no h5py: the HDF5Data layer's list reader is
    # stood in for by the dev split's arrays, the dtypes it would give
    def dev_arrays(list_file):
        return {k: (np.asarray(v, np.int32) if k != "overlap_feat"
                    else np.asarray(v, np.float32))
                for k, v in dev_split.items()}

    eval_net = (main_dir / "eval.prototxt").read_text().replace(
        'batch_size: 50', f'batch_size: {len(dev_split["label"])}', 1)
    (main_dir / "nettest.prototxt").write_text(eval_net)
    real = hdf5_compat.load_hdf5_list
    hdf5_compat.load_hdf5_list = dev_arrays
    try:
        t0 = time.perf_counter()
        nt = json.loads(run_cli(["nettest", "--model",
                                 str(main_dir / "nettest.prototxt"),
                                 "--weights", str(model_path),
                                 "--iterations", "1", "--device",
                                 "cuda"])[-1])
        nettest_s = time.perf_counter() - t0
    finally:
        hdf5_compat.load_hdf5_list = real
    log(f"cli nettest on v4_iter_{GRAPH_STEPS}.caffemodel (the dev split as "
        f"one batch): MAP {nt['map']:.6f} MRR {nt['mrr']:.6f} AUC "
        f"{nt['auc']:.6f}; the solver's last test pass MAP "
        f"{tests[-1]['map']:.6f} (tol 1e-6); {nettest_s:.3f} s [{card}]")
    if abs(nt["map"] - tests[-1]["map"]) > 1e-6:
        raise AssertionError("nettest's MAP differs from the solver's")
    nettest_replays(dev, card, main_dir, model_path, dev_arrays, nt)
    tr = Trainer(dataclasses.replace(V4, vocab_size=vocab), recipe_trainer(),
                 device=dev)
    p0, s0, _ = tr.init()
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logging.getLogger("mms_tpu_torch.trainer").addHandler(handler)
    try:
        tp, ts = tr._load_weights(p0, s0, str(model_path))
    finally:
        logging.getLogger("mms_tpu_torch.trainer").removeHandler(handler)
    for g, t in GRAPH_NAME_MAP.items():
        for k, v in gs.params[g].items():
            if not torch.equal(tp[t][k], v):
                raise AssertionError(f"train --weights: {t}.{k} differs "
                                     f"from the .caffemodel's {g}")
    for bn in ("bn0", "bn1"):
        for k, v in gs.state[bn].items():
            if not torch.equal(ts[bn][k], v):
                raise AssertionError(f"train --weights: state {bn}.{k}")
    log(f"train --weights v4_iter_{GRAPH_STEPS}.caffemodel: the typed "
        f"Trainer's params and BN state equal the solver's, bit for bit "
        f"({records[-1] if records else 'no log'})")
    snap_ms = sync_ms(lambda: gs.snapshot(), 5)
    size = model_path.stat().st_size + (
        main_dir / f"v4_iter_{GRAPH_STEPS}.solverstate").stat().st_size
    del tr, p0, s0, tp, ts

    # ------------------- (4) restored at GRAPH_RESUME_AT = uninterrupted
    runs = {}
    for name in ("full", "part"):
        (root / name).mkdir()
        runs[name] = GraphSolver(graph_files(root / name, vocab, xavier=True),
                                 feeds=feeds, device=dev)
    runs["full"].solve()
    runs["part"].restore(str(root / "full" /
                             f"v4_iter_{GRAPH_RESUME_AT}.solverstate"))
    runs["part"].solve()
    maps = {n: [r["map"] for r in g.history if r["phase"] == "Test#0"]
            for n, g in runs.items()}
    map_diff = abs(maps["part"][-1] - maps["full"][-1])
    worst, where = graph_params_close(to(runs["part"].params, cpu),
                                      to(runs["full"].params, cpu))
    log(f"check GraphSolver restored at {GRAPH_RESUME_AT} from "
        f"v4_iter_{GRAPH_RESUME_AT}.solverstate + .caffemodel (xavier W) "
        f"and solved to {GRAPH_STEPS} vs the uninterrupted run: dev MAP "
        f"{maps['part'][-1]:.6f} vs {maps['full'][-1]:.6f} (abs diff "
        f"{map_diff:.3e}, tol {RESUME_MAP_ATOL:g}; uninterrupted dev MAP "
        f"{[round(x, 4) for x in maps['full']]}); step {GRAPH_STEPS} params "
        f"max diff {worst:.3e} of the leaf's max at {where} (tol "
        f"{RESUME_PARAM_RTOL:g}, conv biases apart) [{card}]")
    if map_diff > RESUME_MAP_ATOL or worst > RESUME_PARAM_RTOL:
        raise AssertionError("a restored GraphSolver run parts from the "
                             "uninterrupted one")
    del runs

    # ------------------- (6) a replayed step = an eager one, bit for bit
    generic_step_replays(dev, card, root, vocab, splits)

    # ------------------------------------------------ times, in turns
    log(f"time GraphSolver.snapshot (BINARYPROTO .caffemodel + .solverstate"
        f", {size / 2**20:.3f} MiB, card to files): p50 {snap_ms:.3f} ms "
        f"[{card}]")
    for bsz in GRAPH_TIMED:
        (root / f"t{bsz}").mkdir()
        g = GraphSolver(graph_files(root / f"t{bsz}", vocab, xavier=False,
                                    batch=bsz, test=False),
                        feeds=graph_feeds(splits, bsz), device=dev)
        g.snapshot_every = 0                # no snapshot inside the timing
        tr = Trainer(dataclasses.replace(V4, vocab_size=vocab),
                     dataclasses.replace(recipe_trainer(), batch_size=bsz),
                     device=dev)
        p, s, o = tr.init(pretrained=info["pretrained"])
        train = tr._full_batch({k: v for k, v in splits["train"].items()
                                if k != "group"})
        tb = next(tr._epoch_batches(train, 0))
        reps = max(10, 1000 // bsz)
        modes = {"eager": lambda: g._train_step(),
                 "replay": lambda: g.step(1),
                 "typed": lambda: tr._train_step(p, s, o, tb, 0)}
        times = {m: [] for m in modes}
        for m in [*modes, *reversed(modes)]:
            times[m].append(sync_ms(modes[m], reps))
        p50 = {m: sum(t) / 2 for m, t in times.items()}
        step_launch = {}
        for m in ("eager", "replay"):
            before = dict(sk.LAUNCH_COUNTS)
            modes[m]()
            torch.cuda.synchronize()
            step_launch[m] = {k: sk.LAUNCH_COUNTS[k] - before[k]
                              for k in before
                              if sk.LAUNCH_COUNTS[k] != before[k]}
        prof = {m: profile_call(fn) for m, fn in modes.items()}
        for m, pr in prof.items():
            pr["idle"] = max(0.0, 1 - pr["device_ms"] / p50[m])
        (st,) = g.runner.stats()
        log(f"time GraphSolver step (V4 recipe net, the feed's host batch "
            f"copied in), eager _train_step vs one replay (step(1)) vs the "
            f"typed fit step, batch {bsz}: eager p50 {p50['eager']:.3f} ms, "
            f"replay {p50['replay']:.3f} ms ({p50['eager'] / p50['replay']:.3f}"
            f"x), typed {p50['typed']:.3f} ms (means of each one's two turns"
            f": {({m: [round(x, 3) for x in t] for m, t in times.items()})}, "
            f"eager, replay, typed, typed, replay, eager); a step launched "
            f"{step_launch}; profiler: " + "; ".join(
                f"{m} {pr['device_ops']} device ops, {pr['device_ms']:.3f} ms"
                f" device time, idle {pr['idle']:.1%}, host "
                f"{pr['host_calls']}" for m, pr in prof.items())
            + f"; capture {st['capture_s']:.3f} s, graph pool "
            f"{st['pool_bytes'] / 2**20:.1f} MiB, a replay launches "
            f"{st['tally']}, {st['replays']} replays [{card}]")
        if any(step_launch[m].get(k) != 1 for m in step_launch
               for k in CLI_TRAIN_KERNELS) \
                or prof["replay"]["host_calls"].get("cudaGraphLaunch") != 1:
            raise AssertionError(f"a generic step launched {step_launch}, "
                                 f"a replay {prof['replay']}")
        del g, tr, p, s, o, train, tb
    del gs
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"graph phase: {time.perf_counter() - started:.1f} s")
    return launches


def netspec_v4(caffe, cfg, *, batch: int = BATCH, phase: str = "train",
               data: str = "data", xavier: bool = False) -> str:
    """The V4 recipe's train or test net written with ``caffe.NetSpec``, as
    the QA script's ``make_net`` writes it (do_trec_qa_clean.py:377-605): an
    HDF5Data layer named ``data``, the shared Embed pair by ParamSpec name,
    SimCross (``xavier`` gives it a xavier weight filler in place of the
    recipe's constant 0), [Dropout], the conv / BN / pool / TanH blocks,
    Flatten + Concat, the MLP, SoftmaxWithLoss, and in test Softmax, MRR,
    MAP and AUC."""
    L, P = caffe.layers, caffe.params
    n = caffe.NetSpec()
    test = phase != "train"
    tops = ["question", "answer", "label"] + (["group"] if test else []) \
        + ["overlap_feat"]
    outs = L.HDF5Data(name=data, batch_size=batch, source="train.txt",
                      shuffle=not test, ntop=len(tops))
    for name, top in zip(tops, outs):
        setattr(n, name, top)
    embed = dict(num_output=cfg.embed_dim, input_dim=cfg.vocab_size,
                 weight_filler=dict(type="uniform",
                                    min=-cfg.embed_init_range,
                                    max=cfg.embed_init_range))
    shared = [dict(name="w2v-weights", lr_mult=1, decay_mult=0),
              dict(name="w2v-bias", lr_mult=2, decay_mult=0)]
    n.w2v_q = L.Embed(n.question, param=shared, embed_param=embed)
    n.w2v_a = L.Embed(n.answer, param=shared, embed_param=embed)
    sim = dict(dist_mode=cfg.sim_mode, mesure_count=cfg.sim_measures,
               bias_term=cfg.sim_bias)
    if xavier:
        sim["weight_filler"] = dict(type="xavier")
    n.sim_cross = L.SimCross(
        n.w2v_q, n.w2v_a, sim_cross_param=sim,
        param=[dict(name="embed-weights", decay_mult=1, lr_mult=1)])
    prev = n.sim_cross
    if cfg.sim_dropout > 0:
        n.sim_drop = L.Dropout(prev, dropout_ratio=cfg.sim_dropout)
        prev = n.sim_drop
    for i, b in enumerate(cfg.blocks):
        conv = L.Convolution(
            prev, kernel_h=b.kh, kernel_w=b.kw, stride=1,
            num_output=b.out_channels, weight_filler=dict(type="xavier"),
            param=[dict(name=f"conv_{i}_w", lr_mult=1),
                   dict(name=f"conv_{i}_b", lr_mult=2, decay_mult=0)])
        bn = L.BN(conv, param=[
            dict(name=f"bn_{i}_shape", lr_mult=1, decay_mult=0),
            dict(name=f"bn_{i}_shift", lr_mult=1, decay_mult=0),
            dict(name=f"bn_{i}_mean", lr_mult=0, decay_mult=0),
            dict(name=f"bn_{i}_variance", lr_mult=0, decay_mult=0)],
            scale_filler=dict(type="constant", value=1),
            shift_filler=dict(type="constant", value=cfg.bn_shift_init))
        pool = L.Pooling(bn, pool=P.Pooling.AVE if b.pool == "ave"
                         else P.Pooling.MAX, kernel_h=b.pool_k,
                         kernel_w=b.pool_k, stride_h=b.pool_stride,
                         stride_w=b.pool_stride)
        setattr(n, f"conv{i}", conv)
        setattr(n, f"bn{i}", bn)
        setattr(n, f"pool{i}", pool)
        setattr(n, f"relu{i}", L.TanH(pool, in_place=True))
        prev = pool
    n.flt = L.Flatten(prev)
    n.feat = L.Concat(n.flt, n.overlap_feat, concat_dim=1)
    n.fc1 = L.InnerProduct(
        n.feat, num_output=cfg.fc1_dim, weight_filler=dict(type="xavier"),
        param=[dict(name="fc1-w", lr_mult=1, decay_mult=0),
               dict(name="fc1-b", lr_mult=2, decay_mult=0)])
    n.relu_fc1 = L.TanH(n.fc1, in_place=True)
    if cfg.fc1_dropout > 0:
        n.drop1 = L.Dropout(n.fc1, dropout_ratio=cfg.fc1_dropout,
                            in_place=True)
    n.fc2 = L.InnerProduct(
        n.fc1, num_output=cfg.num_classes, weight_filler=dict(type="xavier"),
        param=[dict(name="fc2-w", lr_mult=1, decay_mult=0),
               dict(name="fc2-b", lr_mult=2, decay_mult=0)])
    n.loss = L.SoftmaxWithLoss(n.fc2, n.label)
    if test:
        n.prob = L.Softmax(n.fc2)
        n.mrr = L.MRR(n.prob, n.label, n.group)
        n.map = L.MAP(n.prob, n.label, n.group)
        n.auc = L.AUC(n.prob, n.label)
    return str(n.to_proto())


def pycaffe_files(caffe, root: Path, vocab: int, *, xavier: bool = False,
                  still: bool = False, batch: int = BATCH, test: bool = True,
                  solver_type: str = "adadelta") -> str:
    """The NetSpec V4 train net (and test net, its data layer named "dev"
    so one ``feeds=`` dict feeds both) written into ``root`` beside a
    solver prototxt with no test interval (the caller tests through
    ``solver.test_nets``) and no periodic snapshots; returns the solver's
    path."""
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.training import SolverConfig
    from mms_answer_selection_tpu_torch.utils.prototxt import (
        solver_prototxt_from_config)

    cfg = dataclasses.replace(V4, vocab_size=vocab)
    if still:
        cfg = dataclasses.replace(cfg, sim_dropout=0.0, fc1_dropout=0.0)
    (root / "train.prototxt").write_text(
        netspec_v4(caffe, cfg, batch=batch, xavier=xavier))
    (root / "test.prototxt").write_text(
        netspec_v4(caffe, cfg, phase="test", data="dev", xavier=xavier))
    solver = recipe_trainer().solver if solver_type == "adadelta" else \
        SolverConfig(solver_type=solver_type, base_lr=0.1, momentum=0.9,
                     weight_decay=5e-4)
    tcfg = dataclasses.replace(
        recipe_trainer(), max_iter=PYCAFFE_STEPS, test_interval=0,
        snapshot_interval=0, display=0, snapshot_prefix=str(root / "v4"),
        solver=dataclasses.replace(solver, max_iter=PYCAFFE_STEPS))
    (root / "solver.prototxt").write_text(solver_prototxt_from_config(
        tcfg, train_net="train.prototxt",
        test_net="test.prototxt" if test else None))
    return str(root / "solver.prototxt")


def db_images(root: Path) -> tuple[Path, np.ndarray]:
    """DB_IMAGES synthetic 32 x 32 x 3 images as ``.npy`` files (HWC,
    integers in [0, 255]: uint8 Datums hold them exactly) and their
    ``path label`` list; a class is a colour and a stripe, under noise, so
    a small conv net learns it.  Returns (list file, labels)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, DB_CLASSES, DB_IMAGES)
    colours = rng.uniform(40, 215, (DB_CLASSES, 3))
    imgs = rng.normal(0, 30, (DB_IMAGES, DB_HW, DB_HW, 3)) \
        + colours[labels][:, None, None, :]
    for k in range(DB_CLASSES):
        imgs[labels == k, 3 * k:3 * k + 3, :, :] += 60
    imgs = np.clip(np.rint(imgs), 0, 255).astype(np.float32)
    (root / "img").mkdir()
    rows = []
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        np.save(root / "img" / f"{i:05d}.npy", img)
        rows.append(f"img/{i:05d}.npy {int(lab)}")
    (root / "list.txt").write_text("\n".join(rows) + "\n")
    return root / "list.txt", labels


def db_net(caffe, source, *, batch: int, phase: str, head: str = "data",
           deploy: bool = False) -> str:
    """A small conv net over 3 x 32 x 32 images: a Data layer (``head`` =
    "data") or an Input layer (``deploy``; Softmax "prob" on top) or a
    WindowData layer (``head`` = "window", 24 x 24 crops), two conv /
    ReLU / max-pool blocks, two InnerProducts, SoftmaxWithLoss (and
    Accuracy in TEST)."""
    L, P = caffe.layers, caffe.params
    n = caffe.NetSpec()
    if deploy:
        n.data = L.Input(shape=dict(dim=[batch, 3, DB_HW, DB_HW]))
    elif head == "window":
        n.data, n.label = L.WindowData(
            source=str(source), batch_size=batch, fg_threshold=0.5,
            bg_threshold=0.5, fg_fraction=0.25, context_pad=0,
            crop_mode="warp", scale=1 / 256,   # window_data_param's
            transform_param=dict(crop_size=24, mirror=True), ntop=2)
    else:
        n.data, n.label = L.Data(
            source=str(source), batch_size=batch,
            backend=P.Data.LEVELDB if str(source).endswith("leveldb")
            else P.Data.LMDB,
            transform_param=dict(scale=1 / 256), ntop=2)
    xavier = dict(type="xavier")
    n.conv1 = L.Convolution(n.data, num_output=16, kernel_size=5, pad=2,
                            weight_filler=xavier)
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    n.pool1 = L.Pooling(n.conv1, pool=P.Pooling.MAX, kernel_size=2,
                        stride=2)
    n.conv2 = L.Convolution(n.pool1, num_output=32, kernel_size=5, pad=2,
                            weight_filler=xavier)
    n.relu2 = L.ReLU(n.conv2, in_place=True)
    n.pool2 = L.Pooling(n.conv2, pool=P.Pooling.MAX, kernel_size=2,
                        stride=2)
    n.ip1 = L.InnerProduct(n.pool2, num_output=64, weight_filler=xavier)
    n.relu3 = L.ReLU(n.ip1, in_place=True)
    n.ip2 = L.InnerProduct(n.ip1, num_output=DB_CLASSES + (head == "window"),
                           weight_filler=xavier)
    if deploy:
        n.prob = L.Softmax(n.ip2)
        return str(n.to_proto())
    n.loss = L.SoftmaxWithLoss(n.ip2, n.label)
    if phase == "test":
        n.acc = L.Accuracy(n.ip2, n.label)
    return str(n.to_proto())


def pycaffe_forward_replays(caffe, card: str, root: Path, vocab: int,
                            feeds: dict, solver, model_path: str,
                            dev_batch: dict) -> None:
    """The pycaffe forwards as replays against their eager calls (the
    owner's ``GraphedCall`` with its capture off: the same body on the
    same static buffers), bit for bit: ``caffe.Net(test, TEST,
    weights=)`` and ``solver.test_nets[0]`` on the dev split, each timed
    in turns; ``solver.net.forward()`` (train phase: dropout draws, the BN
    statistics move into the solver's carry) twice on two fresh solvers,
    one replaying, one eager: blobs and BN state equal."""
    def tensors(out):
        return {k: b.tensor for k, b in out.items()}

    net = caffe.Net(str(root / "recipe" / "test.prototxt"), caffe.TEST,
                    weights=model_path)
    net.forward(**dev_batch)                # loads the weights
    net.forwards.drop()

    def net_forward():
        return tensors(net.forward(**dev_batch))

    n = len(dev_batch["label"])
    graphed_vs_eager(f"caffe.Net.forward (NetSpec V4 test net, dev split {n}"
                     f" pairs)", net.forwards, net_forward,
                     capture_off(net.forwards, net_forward), 20, card)
    calls = solver._gs.forwards
    calls.drop()

    def view_forward():
        return tensors(solver.test_nets[0].forward())

    graphed_vs_eager(f"solver.test_nets[0].forward() (NetSpec V4 test net, "
                     f"dev split {n} pairs)", calls, view_forward,
                     capture_off(calls, view_forward), 20, card)
    pair = []
    for side in ("replay", "eager"):
        (root / f"view_{side}").mkdir()
        pair.append(caffe.get_solver(pycaffe_files(
            caffe, root / f"view_{side}", vocab, xavier=True), feeds=feeds))
    pair[1]._gs.forwards.captures = False
    outs = [tuple(tensors(sv.net.forward()) for _ in range(2))
            for sv in pair]
    la, lb = (solver_leaves(sv._gs) for sv in pair)
    unequal = [k for k in lb if not torch.equal(la[k], lb[k])]
    (st,) = pair[0]._gs.forwards.stats()
    log(f"check solver.net.forward() x 2 (NetSpec V4 train net, dropout "
        f"on, BN statistics into the solver's carry), replayed vs eager: "
        f"blobs equal {same_tensors(outs[0], outs[1])}, "
        f"{len(lb) - len(unequal)} of {len(lb)} carry leaves equal; "
        f"{st['replays']} "
        f"replays, a replay launches {st['tally']}, capture "
        f"{st['capture_s']:.3f} s, graph pool +{st['pool_bytes'] / 2**20:.1f}"
        f" MiB [{card}]")
    if not same_tensors(outs[0], outs[1]) or unequal or st["replays"] != 2:
        raise AssertionError(f"a replayed solver.net.forward() differs from "
                             f"the eager one: {unequal}")


def pycaffe_phase(dev, card: str, splits, info) -> dict:
    """The reference QA script's own flow through the pycaffe surface
    (``caffe_compat``) at V4's widths over the recipe-sized corpus, and the
    reference's databases and tools on top of it.  It fails unless (1) the
    NetSpec V4 train and test nets parse as ``net_prototxt_from_config``'s
    and a ``.caffemodel`` loaded into each gives one loss to 1e-6, (2) one
    ``solver.step(1)`` under ``set_mode_gpu()`` equals one under
    ``set_mode_cpu()`` (dropout left out, AdaDelta after an SGD warm
    start from a xavier W: graph_phase check 2's tolerances), (3) a
    PYCAFFE_STEPS-step AdaDelta solve in ``solver.step(PYCAFFE_EVERY)``
    calls from the recipe's W = 0 launches the three pair-map kernels
    once a step, its train loss falls, the test net's MAP / MRR blobs
    equal the in-process metrics, ``caffe.Net(test, TEST, weights=
    snapshot)`` equals the solver's test net, and the ``.data[...] = x``
    idiom equals ``forward(**x)``, (4) ``convert_imageset`` writes LMDB and
    LevelDB databases whose first Data-layer batches are equal, a conv
    net trains on the LMDB through ``solve`` (its loss falls),
    ``extract_features`` equals ``caffe.Net``'s forward and a WindowData
    net takes WINDOW_STEPS steps, (5) ``classify``, ``detect``, ``draw``,
    ``upgrade --binary`` and ``convert`` give what their in-process
    counterparts give.  Times the pycaffe step against GraphSolver's at
    PYCAFFE_TIMED batches, the Data feeds and ``classify``.  Returns the
    solve's launches."""
    import dataclasses
    import logging
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch import caffe_compat as caffe
    from mms_answer_selection_tpu_torch.metrics import (
        mean_average_precision, mean_reciprocal_rank)
    from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
    from mms_answer_selection_tpu_torch.models.mms_qa import V4, mms_qa_init
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.training.checkpoint import (
        load_checkpoint, save_checkpoint)
    from mms_answer_selection_tpu_torch.training.graph_solver import (
        _build_feed)
    from mms_answer_selection_tpu_torch.utils.caffemodel import (
        load_caffemodel_auto, save_caffemodel_binaryproto)
    from mms_answer_selection_tpu_torch.utils.prototxt import (
        net_prototxt_from_config, parse_prototxt)
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    vocab = info["vocab_size"]
    feeds = graph_feeds(splits)
    cpu = torch.device("cpu")
    dev_split = splits["dev"]
    dev_keys = ("question", "answer", "label", "group", "overlap_feat")
    dev_batch = {k: dev_split[k] for k in dev_keys}
    caffe.set_mode_gpu()

    def to(tree, where):
        return tree_map(lambda t: t.to(where), tree)

    # --------------------- (1) NetSpec writes what make_net writes
    cfg = dataclasses.replace(V4, vocab_size=vocab)
    for ph, ph2 in (("train", "train"), ("test", "eval")):
        if parse_prototxt(netspec_v4(caffe, cfg, phase=ph)) != \
                parse_prototxt(net_prototxt_from_config(cfg, phase=ph2)):
            raise AssertionError(f"the NetSpec V4 {ph} net differs from "
                                 f"net_prototxt_from_config's")
    still = dataclasses.replace(cfg, sim_dropout=0.0, fc1_dropout=0.0,
                                sim_weight_init="xavier")
    tp, ts = mms_qa_init(still, generator=torch.Generator().manual_seed(SEED),
                         device=dev)
    model = root / "typed.caffemodel"
    save_caffemodel_binaryproto(str(model), tp, ts)
    one = {k: v[:BATCH] for k, v in dev_batch.items()}
    losses1 = []
    for text in (netspec_v4(caffe, still, phase="test", data="dev"),
                 net_prototxt_from_config(still, phase="eval")):
        (root / "n1.prototxt").write_text(text)
        net = caffe.Net(str(root / "n1.prototxt"), caffe.TEST,
                        weights=str(model))
        losses1.append(float(net.forward(**one)["loss"]))
    log(f"check NetSpec V4 nets: train and test parse as "
        f"net_prototxt_from_config's; one .caffemodel in both test nets "
        f"(batch {BATCH}): loss {losses1[0]:.7f} vs {losses1[1]:.7f} (tol "
        f"1e-6)")
    if abs(losses1[0] - losses1[1]) > 1e-6:
        raise AssertionError("the NetSpec net's loss differs")
    del tp, ts, net

    # ------------------------------ (2) a pycaffe step, card = CPU
    (root / "warm").mkdir()
    (root / "step").mkdir()
    caffe.set_mode_cpu()
    warm = caffe.SGDSolver(pycaffe_files(
        caffe, root / "warm", vocab, xavier=True, still=True, test=False,
        solver_type="sgd"), feeds=feeds)
    warm.step(GRAPH_WARM_STEPS)
    path = pycaffe_files(caffe, root / "step", vocab, xavier=True,
                         still=True, test=False)
    stepped = []
    for mode in (caffe.set_mode_cpu, caffe.set_mode_gpu):
        mode()
        s = caffe.get_solver(path, feeds=feeds)
        s.net.params = warm.net.params
        s._gs.state = to(warm._gs.state, s._gs.device)
        s.step(1)
        stepped.append((float(s.net.blobs["loss"].data), s._gs.device,
                        to(s.net.params, cpu)))
    (c_loss, c_dev, c_p), (g_loss, g_dev, g_p) = stepped
    loss_rel = abs(g_loss / c_loss - 1)
    worst, where = graph_params_close(g_p, c_p, 2 * 2 * ADADELTA_STEP)
    log(f"check pycaffe solver.step(1) under set_mode_gpu ({g_dev}) vs "
        f"set_mode_cpu ({c_dev}) (NetSpec V4 net without its dropout, "
        f"batch {BATCH}, AdaDelta after {GRAPH_WARM_STEPS} SGD steps from a "
        f"xavier W): loss {g_loss:.6f}, rel err {loss_rel:.3e} (tol 1e-5); "
        f"params max diff {worst:.3e} of the leaf's max at {where} (tol "
        f"1e-4; conv biases within {2 * 2 * ADADELTA_STEP:.3e})")
    if c_dev.type != "cpu" or g_dev.type != dev.type or loss_rel > 1e-5 \
            or worst > 1e-4:
        raise AssertionError("a pycaffe step differs between card and CPU")
    del warm, stepped, s

    # ------------------------- (3) the recipe's solve through pycaffe
    (root / "recipe").mkdir()
    path = pycaffe_files(caffe, root / "recipe", vocab)
    solver = caffe.get_solver(path, feeds=feeds)
    if solver._gs.device.type != dev.type:
        raise AssertionError("get_solver did not run on the card")
    losses = []
    solver.add_callback(lambda: None, lambda: losses.append(
        solver._gs.last_outs["loss"]))
    launches = dict.fromkeys(sk.LAUNCH_COUNTS, 0)
    reads, tests = [], []
    t_solve = 0.0
    for call in range(PYCAFFE_STEPS // PYCAFFE_EVERY):
        for name in sk.LAUNCH_COUNTS:
            sk.LAUNCH_COUNTS[name] = 0
        t0 = time.perf_counter()
        solver.step(PYCAFFE_EVERY)
        torch.cuda.synchronize()
        t_solve += time.perf_counter() - t0
        window = dict(sk.LAUNCH_COUNTS)
        for name, n in window.items():
            launches[name] += n
        # the first call's first step captures the step's graph after a
        # warm-up step run eagerly: one launch more of each kernel
        want = PYCAFFE_EVERY + (call == 0)
        if any(window[k] != want for k in CLI_TRAIN_KERNELS):
            raise AssertionError(f"{PYCAFFE_EVERY} pycaffe steps launched "
                                 f"{window}")
        reads.append(float(solver.net.blobs["loss"].data))
        out = solver.test_nets[0].forward()
        tests.append({k: float(out[k]) for k in ("loss", "map", "mrr")})
    losses = [float(x) for x in losses]
    win = max(1, PYCAFFE_STEPS // 15)
    first, last = np.mean(losses[:win]), np.mean(losses[-win:])
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"the pycaffe train loss did not fall: "
                             f"{first} -> {last}")
    before = dict(sk.LAUNCH_COUNTS)
    tv = solver.test_nets[0]
    out = tv.forward()
    torch.cuda.synchronize()
    test_launch = {k: sk.LAUNCH_COUNTS[k] - before[k] for k in before}
    if test_launch["pair_maps_fwd"] < 1 or test_launch["pair_maps_bwd_w"] \
            or test_launch["pair_maps_bwd_qa"]:
        raise AssertionError(f"a test-net forward launched {test_launch}")
    scores = tv.blobs["prob"].data[:, 1].astype(np.float64)
    np_map = mean_average_precision(scores, dev_split["label"],
                                    dev_split["group"])
    np_mrr = mean_reciprocal_rank(scores, dev_split["label"],
                                  dev_split["group"])
    model_path, state_path = solver.snapshot()
    log(f"pycaffe solve (NetSpec V4 nets, the recipe's W = 0, batch "
        f"{BATCH}, solver.step({PYCAFFE_EVERY}) x "
        f"{PYCAFFE_STEPS // PYCAFFE_EVERY}): {t_solve:.3f} s, train loss "
        f"{first:.4f} -> {last:.4f} (means of the first and last {win}), "
        f"net.blobs['loss'].data after each call "
        f"{[round(x, 4) for x in reads]}, test_nets[0] {tests}; a test-net "
        f"forward launched {test_launch}; MAP blob {float(out['map']):.6f} "
        f"vs in-process {np_map:.6f}, MRR blob {float(out['mrr']):.6f} vs "
        f"{np_mrr:.6f} (tol 1e-6); snapshot {Path(model_path).name} [{card}]")
    if abs(float(out["map"]) - np_map) > 1e-6 \
            or abs(float(out["mrr"]) - np_mrr) > 1e-6:
        raise AssertionError("the test net's MAP / MRR disagree with the "
                             "in-process metrics")
    net = caffe.Net(str(root / "recipe" / "test.prototxt"), caffe.TEST,
                    weights=model_path)
    # a forward returns its output blobs, which the next forward refreshes
    # (pycaffe's views): read them now
    got = {k: float(v) for k, v in net.forward(**dev_batch).items()}
    want = {k: float(v) for k, v in solver.test_nets[0].forward().items()}
    diffs = {k: abs(got[k] - want[k]) for k in ("loss", "map", "mrr", "auc")}
    diffs["prob"] = float(np.abs(net.blobs["prob"].data
                                 - tv.blobs["prob"].data).max())
    shuffled = dict(dev_batch, answer=np.roll(dev_batch["answer"], 1, 0))
    for k, v in shuffled.items():
        net.blobs[k].data[...] = v
    idiom = {k: float(v) for k, v in net.forward().items()}
    direct = {k: float(v) for k, v in net.forward(**shuffled).items()}
    log(f"check caffe.Net(test.prototxt, caffe.TEST, weights="
        f"{Path(model_path).name}).forward(dev) vs solver.test_nets[0]: max "
        f"abs diff {diffs} (tol 1e-6); net.blobs[...].data[...] = x; "
        f"forward(): {idiom} vs forward(**x): {direct} (answers rolled; "
        f"before {got})")
    if max(diffs.values()) > 1e-6 or idiom != direct \
            or idiom["loss"] == got["loss"]:
        raise AssertionError("caffe.Net on the snapshot differs from the "
                             "solver's test net, or the .data idiom")
    pycaffe_forward_replays(caffe, card, root, vocab, feeds, solver,
                            model_path, dev_batch)
    del net, solver, tv

    # ------------------------------------------------ (4) the databases
    (root / "db").mkdir()
    listfile, labels = db_images(root / "db")
    convert_s = {}
    for backend in ("lmdb", "leveldb"):
        t0 = time.perf_counter()
        run_cli(["convert_imageset", str(root / "db"), str(listfile),
                 str(root / "db" / backend), "--backend", backend])
        convert_s[backend] = time.perf_counter() - t0
    first_batch = {}
    for backend in ("lmdb", "leveldb"):
        (root / "db" / f"{backend}.prototxt").write_text(db_net(
            caffe, root / "db" / backend, batch=DB_BATCH, phase="test"))
        net = caffe.Net(str(root / "db" / f"{backend}.prototxt"), caffe.TEST)
        net.forward()
        first_batch[backend] = (net.blobs["data"].data.copy(),
                                net.blobs["label"].data.copy())
    (ld, ll), (vd, vl) = first_batch["lmdb"], first_batch["leveldb"]
    if not (np.array_equal(ld, vd) and np.array_equal(ll, vl)
            and np.array_equal(ll, labels[:DB_BATCH])):
        raise AssertionError("the LMDB and LevelDB first batches differ")
    feed_rate = {}
    for backend in ("lmdb", "leveldb"):
        cfg_ = parse_prototxt(db_net(caffe, root / "db" / backend,
                                     batch=DB_BATCH, phase="train"))
        feed = _build_feed(cfg_["layer"][0], "train", SEED, str(root), None)
        n_b = DB_IMAGES // DB_BATCH
        t0 = time.perf_counter()
        for _ in range(n_b):
            next(feed)
        feed_rate[backend] = n_b * DB_BATCH / (time.perf_counter() - t0)
    (root / "db" / "train.prototxt").write_text(db_net(
        caffe, root / "db" / "lmdb", batch=DB_BATCH, phase="train"))
    (root / "db" / "solver.prototxt").write_text(
        'net: "train.prototxt"\nbase_lr: 0.01\nmomentum: 0.9\n'
        'lr_policy: "fixed"\ntype: "SGD"\n'
        f'max_iter: {DB_STEPS}\ndisplay: 20\naverage_loss: 20\n'
        f'snapshot_prefix: "db"\nrandom_seed: {SEED}\n')
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    glog = logging.getLogger("mms_tpu_torch.graph_solver")
    glog.addHandler(handler)
    glog.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        res = json.loads(run_cli(["solve", "--solver",
                                  str(root / "db" / "solver.prototxt"),
                                  "--device", "cuda"])[-1])
        db_solve_s = time.perf_counter() - t0
    finally:
        glog.removeHandler(handler)
    shown = [float(m.rsplit("=", 1)[1]) for m in records
             if m.startswith("Iteration") and "loss =" in m]
    snap = root / "db" / f"db_iter_{DB_STEPS}.caffemodel"
    log(f"databases: {DB_IMAGES} images of 3 x {DB_HW} x {DB_HW} through "
        f"cli convert_imageset in {convert_s['lmdb']:.3f} s (lmdb) / "
        f"{convert_s['leveldb']:.3f} s (leveldb); the Data layer's first "
        f"batch of {DB_BATCH} equal in both, bit for bit; cli solve of a "
        f"conv net on the LMDB: {DB_STEPS} steps in {db_solve_s:.3f} s, "
        f"smoothed loss {[round(x, 4) for x in shown]} -> {res['loss']:.4f} "
        f"[{card}]")
    if not snap.exists() or not np.isfinite(res["loss"]) \
            or not res["loss"] < shown[0]:
        raise AssertionError("the Data-layer net did not train")
    (root / "db" / "test.prototxt").write_text(db_net(
        caffe, root / "db" / "lmdb", batch=DB_BATCH, phase="test"))
    run_cli(["extract_features", "--model", str(root / "db" / "test.prototxt"),
             "--weights", str(snap), "--blobs", "ip2", "--iterations",
             "2", "--out", str(root / "feat"), "--device", "cuda"])
    net = caffe.Net(str(root / "db" / "test.prototxt"), caffe.TEST,
                    weights=str(snap))
    ref = []
    for _ in range(2):
        net.forward()
        ref.append(net.blobs["ip2"].data.copy())
    got = np.load(root / "feat" / "ip2.npy")
    feat_err = float(np.abs(got - np.concatenate(ref)).max())
    acc = float((got.argmax(1) == labels[:2 * DB_BATCH]).mean())
    log(f"check cli extract_features ip2 over 2 batches vs caffe.Net("
        f"weights=db_iter_{DB_STEPS}.caffemodel).forward() x 2: max abs diff "
        f"{feat_err:.3e} (tol 1e-6); test accuracy {acc:.4f}")
    if got.shape != (2 * DB_BATCH, DB_CLASSES) or feat_err > 1e-6:
        raise AssertionError("extract_features differs from caffe.Net")
    rows = []
    for i in range(WINDOW_IMAGES):
        lab = int(labels[i]) + 1
        rows += [f"# {i}", str(root / "db" / "img" / f"{i:05d}.npy"), "3",
                 str(DB_HW), str(DB_HW), "3",
                 f"{lab} 1.0 0 0 {DB_HW - 1} {DB_HW - 1}",
                 f"{lab} 0.8 2 2 {DB_HW - 3} {DB_HW - 3}",
                 f"{lab} 0.1 0 0 8 8"]
    (root / "db" / "windows.txt").write_text("\n".join(rows) + "\n")
    (root / "db" / "window.prototxt").write_text(db_net(
        caffe, root / "db" / "windows.txt", batch=32, phase="train",
        head="window"))
    (root / "db" / "window_solver.prototxt").write_text(
        'net: "window.prototxt"\nbase_lr: 0.01\nmomentum: 0.9\n'
        f'lr_policy: "fixed"\ntype: "SGD"\nmax_iter: {WINDOW_STEPS}\n'
        f'snapshot_prefix: "win"\nrandom_seed: {SEED}\n')
    ws = caffe.get_solver(str(root / "db" / "window_solver.prototxt"))
    t0 = time.perf_counter()
    ws.step(WINDOW_STEPS)
    torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    win_loss = float(ws.net.blobs["loss"])
    log(f"WindowData net over {WINDOW_IMAGES} images x 3 windows: "
        f"{WINDOW_STEPS} steps in {win_s:.3f} s, loss {win_loss:.4f} "
        f"[{card}]")
    if ws.iter != WINDOW_STEPS or not np.isfinite(win_loss):
        raise AssertionError("the WindowData net did not step")
    del ws, net

    # ------------------------------------------------------ (5) the tools
    tools = root / "tools"
    tools.mkdir()
    run_cli(["image_mean", str(listfile), "--root", str(root / "db"),
             "--out", str(tools / "mean.binaryproto")])
    (tools / "deploy.prototxt").write_text(db_net(
        caffe, None, batch=10, phase="test", deploy=True))
    imgs = np.stack([np.load(root / "db" / "img" / f"{i:05d}.npy")
                     for i in range(CLASSIFY_IMAGES)])
    np.save(tools / "imgs.npy", imgs)
    run_cli(["classify", str(tools / "imgs.npy"), str(tools / "pred.npy"),
             "--model-def", str(tools / "deploy.prototxt"),
             "--pretrained-model", str(snap), "--images-dim", "36,36",
             "--mean-file", str(tools / "mean.binaryproto"),
             "--raw-scale", "1", "--device", "cuda"])
    from mms_answer_selection_tpu_torch.cli import _load_mean

    clf = caffe.Classifier(str(tools / "deploy.prototxt"), str(snap),
                           image_dims=(36, 36),
                           mean=_load_mean(str(tools / "mean.binaryproto")),
                           raw_scale=1.0, channel_swap=(2, 1, 0))
    pred = clf.predict(list(imgs), oversample=True)
    cls_err = float(np.abs(np.load(tools / "pred.npy") - pred).max())
    cls_ms = sync_ms(lambda: clf.predict(list(imgs), oversample=True), 5)
    rows = ["filename,ymin,xmin,ymax,xmax"]
    for i in range(4):
        f = root / "db" / "img" / f"{i:05d}.npy"
        rows += [f"{f},0,0,31,31", f"{f},4,2,27,30"]
    (tools / "windows.csv").write_text("\n".join(rows) + "\n")
    run_cli(["detect", str(tools / "windows.csv"), str(tools / "det.npz"),
             "--model-def", str(tools / "deploy.prototxt"),
             "--pretrained-model", str(snap), "--crop-mode", "list",
             "--context-pad", "4", "--raw-scale", "1", "--device", "cuda"])
    det = caffe.Detector(str(tools / "deploy.prototxt"), str(snap),
                         raw_scale=1.0, channel_swap=(2, 1, 0),
                         context_pad=4)
    by_file = {}
    for r in rows[1:]:
        f, *box = r.split(",")
        by_file.setdefault(f, []).append(np.array([int(x) for x in box]))
    dets = det.detect_windows(sorted(by_file.items()))
    got = np.load(tools / "det.npz")
    det_err = float(np.abs(got["predictions"] - np.stack(
        [d["prediction"] for d in dets])).max())
    dot = run_cli(["draw", "--net", str(root / "recipe" / "train.prototxt")])
    names = [la["name"] for la in parse_prototxt(
        (root / "recipe" / "train.prototxt").read_text())["layer"]]
    missing = [n for n in names if n not in "\n".join(dot)]
    run_cli(["upgrade", "--binary", model_path, str(tools / "up.caffemodel")])
    rt = GraphNet((root / "recipe" / "test.prototxt").read_text(),
                  phase="test")
    p0, s0 = rt.init(torch.Generator(), {k: torch.as_tensor(v[:BATCH])
                                         for k, v in dev_batch.items()},
                     device=cpu)
    specs = rt.caffemodel_specs(p0, s0)
    a = load_caffemodel_auto(model_path, p0, s0, specs=specs)
    b = load_caffemodel_auto(str(tools / "up.caffemodel"), p0, s0,
                             specs=specs)
    up_same = all(torch.equal(x, y) for x, y in zip(
        *(list(_leaves(t[:2])) for t in (a, b))))
    tp, ts = mms_qa_init(cfg, generator=torch.Generator().manual_seed(SEED),
                         device=cpu)
    ck = save_checkpoint(str(tools / "ckpt"), 7,
                         {"params": tp, "state": ts})
    (tools / "data").mkdir()
    (tools / "data" / "meta.json").write_text(json.dumps(
        {"vocab_size": vocab, "unknown_idx": 0, "pad_idx": vocab - 1,
         "dim": cfg.embed_dim, "q_len": cfg.question_len,
         "a_len": cfg.answer_len}))
    np.savez(tools / "data" / "vocab.npz", pretrained=np.zeros((1, D)),
             words=np.asarray(["x"]))
    run_cli(["convert", "--ckpt", ck, "--out", str(tools / "v4.caffemodel")])
    run_cli(["convert", "--caffemodel", str(tools / "v4.caffemodel"),
             "--data", str(tools / "data"), "--out", str(tools / "back")])
    back, _ = load_checkpoint(str(tools / "back" / "imported_iter_0"))
    conv_same = all(np.array_equal(x, y.numpy()) for x, y in zip(
        _leaves((back["params"], back["state"])), _leaves((tp, ts))))
    log(f"check tools: classify {CLASSIFY_IMAGES} .npy images (10-crop "
        f"oversample, mean.binaryproto from image_mean) vs Classifier."
        f"predict: max abs diff {cls_err:.3e} (tol 1e-6); detect "
        f"--crop-mode list over {len(rows) - 1} windows vs detect_windows: {det_err:.3e} (tol 1e-6); draw names "
        f"every layer: {not missing}; upgrade --binary of "
        f"{Path(model_path).name} reads back as the same weights: {up_same};"
        f" convert of a typed V4 checkpoint to .caffemodel and back, bit for "
        f"bit: {conv_same}")
    if cls_err > 1e-6 or det_err > 1e-6 or missing or not up_same \
            or not conv_same:
        raise AssertionError("a tool differs from its in-process "
                             "counterpart")
    del clf, det

    # ------------------------------------------------ (6) times, in turns
    for bsz in PYCAFFE_TIMED:
        (root / f"t{bsz}").mkdir()
        s = caffe.get_solver(pycaffe_files(caffe, root / f"t{bsz}", vocab,
                                           batch=bsz, test=False),
                             feeds=graph_feeds(splits, bsz))
        gs = s._gs
        reps = max(10, 1000 // bsz)
        modes = {"pycaffe": lambda: s.step(1),       # one replay
                 "replay": lambda: gs.step(1),
                 "eager": lambda: gs._train_step()}
        times = {m: [] for m in modes}
        for m in [*modes, *reversed(modes)]:
            times[m].append(sync_ms(modes[m], reps))
        p50 = {m: sum(t) / 2 for m, t in times.items()}
        before = dict(sk.LAUNCH_COUNTS)
        modes["pycaffe"]()
        torch.cuda.synchronize()
        step_launch = {k: sk.LAUNCH_COUNTS[k] - before[k] for k in before
                       if sk.LAUNCH_COUNTS[k] != before[k]}
        prof = {m: profile_call(modes[m]) for m in ("pycaffe", "eager")}
        for m, pr in prof.items():
            pr["idle"] = max(0.0, 1 - pr["device_ms"] / p50[m])
        (st,) = gs.runner.stats()
        log(f"time pycaffe solver.step(1) (NetSpec V4 net; one replay) vs "
            f"GraphSolver's replayed step(1) and eager _train_step on the "
            f"same solver, batch {bsz}: pycaffe p50 {p50['pycaffe']:.3f} ms,"
            f" GraphSolver replay {p50['replay']:.3f} ms, eager "
            f"{p50['eager']:.3f} ms (means of each one's two turns: "
            f"{({m: [round(x, 3) for x in t] for m, t in times.items()})}, "
            f"pycaffe, replay, eager, eager, replay, pycaffe); a pycaffe "
            f"step launched {step_launch}; profiler: " + "; ".join(
                f"{m} {pr['device_ops']} device ops, {pr['device_ms']:.3f} ms"
                f" device time, idle {pr['idle']:.1%}, host "
                f"{pr['host_calls']}" for m, pr in prof.items())
            + f"; capture {st['capture_s']:.3f} s, graph pool "
            f"{st['pool_bytes'] / 2**20:.1f} MiB, a replay launches "
            f"{st['tally']} [{card}]")
        if any(step_launch.get(k) != 1 for k in CLI_TRAIN_KERNELS) \
                or prof["pycaffe"]["host_calls"].get("cudaGraphLaunch") != 1:
            raise AssertionError(f"a pycaffe step launched {step_launch}, "
                                 f"{prof['pycaffe']}")
        del s, gs
    log(f"time Data feeds on the host ({DB_IMAGES} images in batches of "
        f"{DB_BATCH}, decode + transform): LMDB {feed_rate['lmdb']:.1f} "
        f"images/s, LevelDB {feed_rate['leveldb']:.1f} images/s; classify "
        f"(Classifier.predict, 10-crop oversample, 3 x 32 x 32 crops): "
        f"{CLASSIFY_IMAGES} images p50 {cls_ms:.3f} ms, "
        f"{CLASSIFY_IMAGES / cls_ms * 1e3:.1f} images/s [{card}]")
    caffe.set_mode_gpu()
    tmp.cleanup()
    torch.cuda.empty_cache()
    log(f"pycaffe phase: {time.perf_counter() - started:.1f} s")
    return launches


def _leaves(tree):
    """A tree's leaves (dicts, tuples), in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def planted_batch(gen, dev, n: int, cfg):
    """A caption training batch of the planted-signal corpus, made on the
    device from ``gen``: caption token f everywhere, the positive image
    noise at 0.1 with pixel row f at 2 in channel 0, the negative noise."""
    first = torch.randint(0, 8, (n,), generator=gen, device=dev)
    shape = (n, cfg.height, cfg.width, cfg.channels)
    pos = 0.1 * torch.randn(shape, generator=gen, device=dev)
    pos[torch.arange(n, device=dev), first, :, 0] += 2.0
    return {"caption": first[:, None].expand(n, cfg.caption_len).contiguous(),
            "image_pos": pos,
            "image_neg": torch.randn(shape, generator=gen, device=dev)}


def pool_images(gen, dev, n: int, cfg):
    """An image pool of the same corpus: half the images planted with a
    token f in [0, 8), half noise."""
    f = torch.randint(0, 16, (n,), generator=gen, device=dev)
    imgs = torch.randn((n, cfg.height, cfg.width, cfg.channels),
                       generator=gen, device=dev)
    rows = (f < 8).nonzero().flatten()
    imgs[rows] *= 0.1
    imgs[rows, f[rows], :, 0] += 2.0
    return imgs


def caption_queries(gen, dev, n: int, cfg):
    """Caption ids: token f in every slot, a quarter of them replaced by
    random words."""
    first = torch.randint(0, 8, (n, 1), generator=gen, device=dev)
    noise = torch.randint(0, cfg.vocab_size, (n, cfg.caption_len),
                          generator=gen, device=dev)
    keep = torch.rand((n, cfg.caption_len), generator=gen, device=dev) < 0.75
    return torch.where(keep, first, noise)


def stacked(batches, where) -> dict:
    """A chunk's batches as (K, ...) tensors on ``where``."""
    return {k: torch.stack([b[k] for b in batches]).to(where)
            for k in batches[0]}


def steps_card_vs_cpu(make_trainer, batches, checks, dev,
                      label: str) -> dict:
    """The same training steps on the CPU and on the card from the same
    weights (drawn on the CPU) and batches, through ``scan_train_steps`` in
    chunks that end at each step in ``checks`` (one graph replay a chunk
    on the card, eager steps on the CPU); after each such step the loss
    within MM_LOSS_RTOL relative and every param leaf within MM_PARAM_RTOL
    of its max |value| (MM_NOISE_LEAVES within AdaDelta's band of 2 x
    lr_mult 2 x its normalized step a step).  Returns the measured worst
    differences by step."""
    from mms_answer_selection_tpu_torch.utils.tree import tree_map

    runs = []
    for where in (torch.device("cpu"), dev):
        tr = make_trainer(where)
        p, s, o = tr.init()
        runs.append([])
        done = 0
        for step in checks:
            p, s, o, losses = tr.scan_train_steps(
                p, s, o, stacked(batches[done:step], where), done)
            done = step
            runs[-1].append(tree_map(lambda t: t.detach().cpu(),
                                     {"p": p, "loss": losses[-1]}))
    measured = {}
    for step, cpu, card in zip(checks, *runs):
        loss_rel = abs(float(card["loss"]) / float(cpu["loss"]) - 1)
        worst, where, band = 0.0, "", 2 * 2 * ADADELTA_STEP * step
        for name, sub in cpu["p"].items():
            for k, want in sub.items():
                diff = float((card["p"][name][k] - want).abs().max())
                if f"{name}.{k}" in MM_NOISE_LEAVES:
                    if diff > band:
                        raise AssertionError(f"{label} step {step}: {name}.{k}"
                                             f" moved {diff:.3e} apart")
                    continue
                rel = diff / max(float(want.abs().max()), 1e-30)
                if rel > worst:
                    worst, where = rel, f"{name}.{k}"
        log(f"check {label} card vs CPU after {step} step(s): loss "
            f"{float(card['loss']):.6f}, rel diff {loss_rel:.3e} (tol "
            f"{MM_LOSS_RTOL:g}); params max diff / leaf max {worst:.3e} at "
            f"{where} (tol {MM_PARAM_RTOL:g}; {', '.join(MM_NOISE_LEAVES)} "
            f"within {band:.3e})")
        if loss_rel > MM_LOSS_RTOL or worst > MM_PARAM_RTOL:
            raise AssertionError(f"{label}: card and CPU part after {step} "
                                 f"step(s)")
        measured[step] = (loss_rel, worst)
    return measured


def multimodal_phase(sk, normal, dev, card: str, max_err: dict) -> dict:
    """The multimodal side at its published defaults: the pair-map kernels
    at (W1, W2, M) = (12, 25, 2) and the MaxSim kernels at R = 24, W2P = 32
    against their plain versions; MM_STEPS caption-to-image AdaDelta steps
    through ``Trainer(apply_fn=caption_image_apply, init_fn=
    caption_image_init)`` (rank accuracy must rise, card = CPU after
    MM_CHECK_STEPS, launches counted); POOL images encoded in chunks into
    bf16, int8 and int4 engines (``build_index_from_tokens`` from the
    host), queried with 1 and 256 captions (top-10 = brute force, bf16
    against the float32 ``caption_image_score``, p50s); PAIR_STEPS
    image-pair steps from ``PairImageDataset`` (the loss falls, card = CPU
    after one).  Returns the launches of each path."""
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch.data.pair_image import (
        PairImageDataset, synthetic_pair_corpus)
    from mms_answer_selection_tpu_torch.models import (
        CaptionImageConfig, MMSQAConfig, PairImageConfig,
        caption_image_apply, caption_image_init, caption_image_score,
        encode_image, pair_image_apply, pair_image_init)
    from mms_answer_selection_tpu_torch.ops.embed import embed_lookup
    from mms_answer_selection_tpu_torch.serve import QueryEngine
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)

    cfg = CaptionImageConfig()
    if cfg.patch_grid() != (5, 5) or cfg.sim_measures != MM_M:
        raise AssertionError(f"CaptionImageConfig() moved: {cfg}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    # ------------------------------------- kernels vs plain at these shapes
    pairs = pair_kernels(sk)
    for n, w1, w2, d, m in MM_PAIR_CHECKS:
        check_pair_kernels(sk, pairs, pair_operands(normal, n, d, w1, w2, m),
                           max_err)
    w_mm = normal(MM_M, D, D, scale=0.05)
    for name in MAXSIM:
        for nq in MM_KERNEL_NQ:
            for c in KERNEL_POOLS:
                args = scorer_args(sk, name, normal(nq, MM_W1, D, scale=0.3),
                                   normal(c, MM_P, D, scale=0.3), w_mm)
                check_maxsim(sk, name, args, f"R={MM_M * MM_W1} W2={MM_P} "
                             f"nq={nq} C={c}", max_err)

    # ---------------------------------------------- caption training, once
    tcfg = TrainerConfig(solver=SolverConfig(solver_type="adadelta",
                                             weight_decay=0.0),
                         batch_size=BATCH, seed=SEED + 2)
    seen = []   # (captured?, rank accuracy) of each training forward

    def recorded(params, state, batch, model_cfg, *, train, generator=None):
        out, new_state = caption_image_apply(params, state, batch, model_cfg,
                                             train=train, generator=generator)
        if train:
            seen.append((torch.cuda.is_current_stream_capturing(),
                         out["rank_accuracy"].detach()))
        return out, new_state

    def caption_trainer(where, apply_fn=caption_image_apply):
        return Trainer(cfg, tcfg, device=where, apply_fn=apply_fn,
                       init_fn=caption_image_init)

    batches = [planted_batch(gen, dev, BATCH, cfg) for _ in range(MM_STEPS)]
    steps_card_vs_cpu(caption_trainer, batches, MM_CHECK_STEPS, dev,
                      "caption step")
    tr = caption_trainer(dev, recorded)
    p, s, o = tr.init()
    torch.cuda.synchronize()
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    t0 = time.perf_counter()
    losses, accs, outputs = [], [], {}
    for a in range(0, MM_STEPS, MM_ACC_WINDOW):   # chunks of the window
        chunk = batches[a:a + MM_ACC_WINDOW]
        n_seen = len(seen)
        p, s, o, loss = tr.scan_train_steps(p, s, o, stacked(chunk, dev), a)
        # a replay runs no Python: the captured forwards' accuracies are
        # the graph's outputs, rewritten by each replay
        captured = [x for capturing, x in seen[n_seen:] if capturing]
        if captured:
            outputs[len(chunk)] = captured
        accs.append(torch.stack(outputs[len(chunk)]))
        losses.append(loss)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = dict(sk.LAUNCH_COUNTS)
    acc = torch.cat(accs).cpu().numpy()
    first, last = acc[:MM_ACC_WINDOW].mean(), acc[-MM_ACC_WINDOW:].mean()
    losses = torch.cat(losses).cpu().numpy()
    log(f"launches of {MM_STEPS} caption training steps: {trained} (per "
        f"step {({k: v / MM_STEPS for k, v in trained.items() if v})}; "
        f"{tr.runner.replays} graph replays of {MM_ACC_WINDOW} steps)")
    if tr.runner.replays != MM_STEPS // MM_ACC_WINDOW:
        raise AssertionError("caption training: a chunk was not one replay")
    for name in CLI_TRAIN_KERNELS:
        if trained[name] < 1:
            raise AssertionError(f"caption training never launched {name}")
    log(f"caption training ({MM_STEPS} AdaDelta steps, batch {BATCH}, "
        f"{train_s:.3f} s): loss {losses[0]:.4f} -> "
        f"{losses[-MM_ACC_WINDOW:].mean():.4f}, rank accuracy first "
        f"{MM_ACC_WINDOW} {first:.4f}, last {MM_ACC_WINDOW} {last:.4f} (held "
        f"above max(0.6, first))")
    if not np.isfinite(losses).all() or not last > max(0.6, first):
        raise AssertionError("caption training did not learn the planted "
                             "alignment")
    step_ms = sync_ms(lambda: tr._train_step(p, s, o, batches[0], 0), 100)
    log(f"time caption train step batch {BATCH}: p50 {step_ms:.3f} ms "
        f"({1e3 / step_ms:.1f} steps/s) [{card}]")

    # ------------------------- pair-map times at the caption shapes
    timed = {}
    for n, w1, w2, d, m in MM_PAIR_CHECKS:
        ops = pair_operands(normal, n, d, w1, w2, m)
        for name in pairs:
            k_ms, p_ms, t = in_turns(*pairs[name], ops)
            b_ms, b_by = pair_bound(name, n, d, w1, w2, m)
            timed[name, n] = (k_ms, p_ms, b_ms)
            plain = "plain (2 einsums)" if name == "pair_maps_bwd_qa" \
                else "einsum"
            log(f"time {name} at N={n}, W1={w1}, W2={w2}, D={d}, M={m}: "
                f"kernel {k_ms:.4f} ms, {plain} {p_ms:.4f} ms "
                f"({p_ms / k_ms:.2f}x), bound {b_ms:.4f} ms "
                f"({b_by}; {b_ms / k_ms:.1%} of it reached) "
                f"[{[round(x, 4) for x in t]}; {card}]")

    # ------------------------------------------------------- the image pool
    with torch.no_grad():
        images = pool_images(gen, dev, POOL, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = [encode_image(p, s, images[a:a + MM_ENCODE_CHUNK], cfg,
                               train=False)[0]
                  for a in range(0, POOL, MM_ENCODE_CHUNK)]
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        tokens = torch.cat([c.cpu() for c in chunks])   # a host source
        del images, chunks
    log(f"time encode_image: {POOL} images in chunks of {MM_ENCODE_CHUNK} in "
        f"{encode_s * 1e3:.3f} ms ({POOL / encode_s:.4g} images/s); tokens "
        f"{tuple(tokens.shape)} on the host, {tokens.numel() * 4 / 2**30:.3f} "
        f"GiB [{card}]")
    if not torch.isfinite(tokens).all():
        raise AssertionError("encode_image: tokens not finite")
    qa = MMSQAConfig(vocab_size=cfg.vocab_size, embed_dim=cfg.embed_dim,
                     sim_measures=cfg.sim_measures)
    q_tok = embed_lookup(p["embed"], caption_queries(gen, dev, N_QUERIES,
                                                     cfg)).detach()
    engines, results = {}, {}
    for pd in POOL_DTYPES:
        t0 = time.perf_counter()
        engines[pd] = QueryEngine(p, qa, pool_dtype=pd, chunk_size=CHUNK,
                                  device=dev).build_index_from_tokens(tokens)
        torch.cuda.synchronize()
        log(f"image engine {pd}: built {POOL} images in "
            f"{time.perf_counter() - t0:.3f} s from the host, pool "
            f"{gib(engines[pd]):.3f} GiB, {tuple(engines[pd].pool.shape)}")
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    for pd, eng in engines.items():          # the image-pool path, once
        results[pd] = (eng.query(q_tok[:1], k=K), eng.query(q_tok, k=K))
    torch.cuda.synchronize()
    served = dict(sk.LAUNCH_COUNTS)
    log(f"launches of the image-pool queries (1 and {N_QUERIES} captions on "
        f"each dtype): {served}")
    for name in MAXSIM:
        if served[name] < 1:
            raise AssertionError(f"the image pool never launched {name}")
    for pd, eng in engines.items():
        (v1, i1), (vals, idx) = results[pd]
        if vals.shape != (N_QUERIES, K) or not torch.isfinite(vals).all() \
                or not (torch.equal(v1, vals[:1])
                        and torch.equal(i1, idx[:1])):
            raise AssertionError(f"image pool {pd}: bad query result")
        check_topk(eng, q_tok[:N_CHECK], vals[:N_CHECK], idx[:N_CHECK],
                   f"image pool {pd}")
    def exact_scores(q):
        """(POOL,) float32 scores of one caption by the model's scorer."""
        out = []
        for a in range(0, POOL, MM_ENCODE_CHUNK):
            img = tokens[a:a + MM_ENCODE_CHUNK].to(dev)
            cap = q[None].expand(img.shape[0], -1, -1).contiguous()
            out.append(caption_image_score(p, cap, img, cfg))
        return torch.cat(out)

    with torch.no_grad():
        exact = torch.stack([exact_scores(q) for q in q_tok[:N_CHECK]])
    want = exact.topk(K, dim=1).indices
    agree = {pd: float((results[pd][1][1][:N_CHECK, :, None]
                        == want[:, None, :]).any(-1).float().mean())
             for pd in POOL_DTYPES}
    log(f"image pool top-{K} = brute force on its own pool ({N_CHECK} "
        f"queries, each dtype); top-{K} overlap with float32 "
        f"caption_image_score on {N_CHECK} queries: {agree}")
    for pd, eng in engines.items():
        one = sync_ms(lambda: eng.query(q_tok[:1], k=K), 20)
        full = sync_ms(lambda: eng.query(q_tok, k=K), 5)
        ops = (*eng.project(q_tok), eng.pool) \
            + (() if eng.aux is None else (eng.aux,))
        name = "maxsim_" + pd
        scan = burst_ms(lambda: maxsim_scorers(sk)[name][0](*ops), 5)
        b_ms, b_by = maxsim_bound(name, ops, N_QUERIES * POOL * 4,
                                  cfg.embed_dim, MM_M * MM_W1, MM_P)
        small = scorer_args(sk, name, normal(TIMED_NQ, MM_W1, D, scale=0.3),
                            normal(TIMED_POOL, MM_P, D, scale=0.3), w_mm)
        k_ms, p_ms, _ = in_turns(*maxsim_scorers(sk)[name], small, 20, 5)
        sb_ms, sb_by = maxsim_bound(name, small, TIMED_NQ * TIMED_POOL * 4,
                                    D, MM_M * MM_W1, MM_P)
        log(f"time image engine {pd} at {POOL} (chunks of {CHUNK}): query 1q "
            f"p50 {one:.3f} ms, query {N_QUERIES}q p50 {full:.3f} ms "
            f"({N_QUERIES * POOL / full * 1e3:.4g} pairs/s; kernel alone, "
            f"unchunked, {scan:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{b_ms / scan:.1%} of it reached)); {name} {TIMED_NQ}q x "
            f"{TIMED_POOL}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{sb_ms:.4f} ms ({sb_by}) [{card}]")
        del ops
    del engines, results, tokens, exact
    torch.cuda.empty_cache()

    # ------------------------------------------------ image-pair training
    tmp = tempfile.TemporaryDirectory()
    pcfg = PairImageConfig()
    listing = synthetic_pair_corpus(tmp.name, n_pairs=PAIR_CORPUS,
                                    hw=pcfg.height, channels=pcfg.channels,
                                    seed=SEED)
    data = PairImageDataset(listing, BATCH, root=tmp.name, seed=SEED)
    t0 = time.perf_counter()
    pair_batches = [{k: torch.as_tensor(v) for k, v in next(data).items()
                     if k != "angles"} for _ in range(PAIR_STEPS)]
    load_s = time.perf_counter() - t0
    tmp.cleanup()

    def pair_trainer(where):
        return Trainer(pcfg, tcfg, device=where, apply_fn=pair_image_apply,
                       init_fn=pair_image_init)

    steps_card_vs_cpu(pair_trainer, pair_batches, (1,), dev,
                      "image-pair step")
    tr = pair_trainer(dev)
    p, s, o = tr.init()
    on_card = [{k: v.to(dev) for k, v in b.items()} for b in pair_batches]
    t0 = time.perf_counter()
    losses = []
    for a in range(0, PAIR_STEPS, 10):               # chunks of 10 steps
        p, s, o, loss = tr.scan_train_steps(
            p, s, o, stacked(on_card[a:a + 10], dev), a)
        losses.append(loss)
    losses = torch.cat(losses).cpu().numpy()
    pair_s = time.perf_counter() - t0
    if tr.runner.replays != PAIR_STEPS // 10:
        raise AssertionError("image-pair training: a chunk was not one "
                             "replay")
    log(f"image-pair training ({PAIR_STEPS} steps, batch {BATCH}, "
        f"{PAIR_CORPUS} pairs through PairImageDataset, loaded in "
        f"{load_s:.3f} s; {pair_s:.3f} s): loss {losses[:10].mean():.4f} "
        f"(first 10) -> {losses[-10:].mean():.4f} (last 10) [{card}]")
    if not np.isfinite(losses).all() \
            or not losses[-10:].mean() < losses[:10].mean():
        raise AssertionError("image-pair training: the loss did not fall")
    return {"caption training": trained, "image pool": served}


# ----------------------------------------------------------------- the tail
# the rest of the JAX package's surface (tail_phase): `time` at TAIL_TIMED
# batches and over a POOL-candidate int8 pool; an exported scorer called at
# TAIL_EXPORT_BATCHES; the bf16 forward at batch 1024 against float32 (P
# moved within TAIL_BF16_P_BAND); TAIL_STEPS steps of Trainer(mesh=) on one
# NCCL rank and on two gloo ranks sharing the card, held to the plain
# Trainer (bit for bit at one rank, STEP_RTOL / STEP_ATOL at two: the
# tests' STEP_TOL); one tp = 2 sharded step against the unsharded one; a
# POOL-candidate engine over two ranks against one process, exactly; the
# matcaffe bridge over a socket
TAIL_TIMED = (BATCH, 1024)
TAIL_EXPORT_BATCHES = (1, BATCH, 1024)
# bf16 moved P by 2.986e-5 at batch 1024 here (NVIDIA H100 80GB HBM3,
# 700 W); a cast in another place, or none, falls outside a third to two
# and a half times that
TAIL_BF16_P_BAND = (1e-5, 7.5e-5)
TAIL_STEPS, TAIL_TIMED_STEPS = 20, 10
STEP_RTOL, STEP_ATOL = 1e-4, 1e-4
TAIL_ENGINES = ("int8", "bf16")
TAIL_NOISE = ("conv0.b", "conv1.b")   # rounding-noise gradients (train BN)


def _tail_numpy(tree):
    return {k: _tail_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def _tail_named(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _tail_named(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v.detach().cpu()))
    return out


def _tail_close(got, want, band: float, what: str) -> float:
    """Leaf by leaf within STEP_RTOL / STEP_ATOL, the conv biases within
    ``band``; returns the largest difference over the leaf's max."""
    worst = 0.0
    for (name, g), (name2, w) in zip(_tail_named(got), _tail_named(want)):
        assert name == name2, (name, name2)
        diff = float((g - w).abs().max())
        if name in TAIL_NOISE:
            if diff > band:
                raise AssertionError(f"{what}: {name} moved {diff} > {band}")
            continue
        if not torch.allclose(g, w, rtol=STEP_RTOL, atol=STEP_ATOL):
            raise AssertionError(f"{what}: {name} off by {diff}")
        worst = max(worst, diff / max(float(w.abs().max()), 1e-30))
    return worst


def _tail_step_ms(trainer, params, state, opt, batches, step0: int):
    """Each step's wall time in ms (ended by a device sync) and the state
    after them."""
    times = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, state, opt, _ = trainer._train_step(params, state, opt, b,
                                                    step0 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _tail_trainer(cfg, mesh=None):
    """The recipe's Trainer on this process's card, its solver built."""
    from mms_answer_selection_tpu_torch.training import Trainer

    trainer = Trainer(cfg, recipe_trainer(), device="cuda", mesh=mesh)
    trainer.init()
    return trainer


def _tail_dp_run(trainer, params, state, batches, n_timed: int) -> dict:
    """TAIL_STEPS steps of ``trainer`` from ``params`` / ``state`` (numpy)
    over ``batches`` (numpy): the losses and the state after them, then
    ``n_timed`` more steps' times."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy

    p, s = params_from_numpy(params, state, trainer.device)
    o = trainer.solver.init(p)
    bs = [{k: torch.as_tensor(v, device=trainer.device) for k, v in
           b.items()} for b in batches]
    losses = []
    for i, b in enumerate(bs):
        p, s, o, loss = trainer._train_step(p, s, o, b, i)
        losses.append(float(loss))
    times = _tail_step_ms(trainer, p, s, o, bs[:n_timed], len(bs))
    return {"losses": losses, "params": p, "step_ms": times}


def _tail_sharded_step(params, state, batch, n_timed, mesh) -> dict:
    """One step of ``build_sharded_train_step`` on ``mesh`` from ``params``
    (numpy; this rank keeps its slices): the loss, this rank's slices and
    tp rank after it, then ``n_timed`` more steps' times."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.models.mms_qa import (MMSQAConfig,
                                                              param_spec)
    from mms_answer_selection_tpu_torch.parallel import (
        build_sharded_train_step, params_pspec, shard_pytree)
    from mms_answer_selection_tpu_torch.training.optim import make_solver

    cfg = MMSQAConfig(vocab_size=VOCAB)
    dev = torch.device("cuda", torch.cuda.current_device())
    p, s = params_from_numpy(params, state, dev)
    p = shard_pytree(p, mesh, params_pspec(p, mesh))
    solver = make_solver(recipe_trainer().solver, param_spec(p, cfg))
    o = solver.init(p)
    step = build_sharded_train_step(cfg, solver, mesh)(p, s, o)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def gen(i):
        return torch.Generator(device=dev).manual_seed(SEED + i)

    p, s, o, loss = step(p, s, o, b, 0, gen(0))
    times = []
    for i in range(n_timed):
        t0 = time.perf_counter()
        step(p, s, o, b, 1 + i, gen(1 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": float(loss), "params": p, "step_ms": times,
            "tp_rank": mesh.get_local_rank("tp")}


def tail_rank(params, state, batches, serve_params, queries) -> dict:
    """What each of the ranks sharing the card runs (``parallel.launch``,
    gloo): TAIL_STEPS steps of Trainer(mesh=) over every rank, one tp step
    over a (1, ranks) mesh, and a POOL-candidate engine of each
    TAIL_ENGINES dtype split over every rank.  ``launches``: this rank's
    kernel launches in each of those parts, each counted from 0."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.models.mms_qa import MMSQAConfig
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
    from mms_answer_selection_tpu_torch.parallel import make_mesh
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    def counted(part, fn):
        for name in sk.LAUNCH_COUNTS:
            sk.LAUNCH_COUNTS[name] = 0
        out[part] = fn()
        launches[part] = {k: v for k, v in sk.LAUNCH_COUNTS.items() if v}

    torch.backends.cuda.matmul.allow_tf32 = False   # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    cfg = MMSQAConfig(vocab_size=VOCAB)
    world = torch.distributed.get_world_size()
    out, launches = {}, {}
    counted("dp", lambda: _tail_dp_run(_tail_trainer(cfg, make_mesh(
        devices="cuda")), params, state, batches, TAIL_TIMED_STEPS))
    counted("tp", lambda: _tail_sharded_step(
        params, state, batches[0], TAIL_TIMED_STEPS,
        make_mesh(1, world, devices="cuda")))
    mesh = make_mesh(devices="cuda")
    p, _ = params_from_numpy(serve_params, {}, "cuda")
    q = torch.as_tensor(queries, device="cuda")

    def serve(pd):
        eng = QueryEngine(p, cfg, pool_dtype=pd, chunk_size=CHUNK,
                          mesh=mesh).build_index(_tail_pool(cfg))
        vals, idx = eng.query(q, k=K)
        ms = sync_ms(lambda: eng.query(q, k=K), 10)
        del eng
        torch.cuda.empty_cache()
        return vals, idx, ms

    for pd in TAIL_ENGINES:
        counted(pd, lambda: serve(pd))
    out["launches"] = launches
    return out


def _tail_pool(cfg):
    """The serving pool's candidate ids, made alike in every process."""
    g = torch.Generator().manual_seed(SEED + 7)
    return torch.randint(0, cfg.vocab_size, (POOL, W2), generator=g)


def _tail_time(sk, card: str, tmp: Path) -> None:
    """`time` on the card: the per-stage table at TAIL_TIMED batches, the
    V4 recipe's net through --model, the serving lifecycle at POOL."""
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.utils.prototxt import \
        net_prototxt_from_config

    for b in TAIL_TIMED:
        before = dict(sk.LAUNCH_COUNTS)
        out = json.loads(run_cli(["time", "--batch", str(b), "--iters",
                                  "10", "--fused-steps", "4"])[-1])
        for name in CLI_TRAIN_KERNELS:
            if sk.LAUNCH_COUNTS[name] <= before[name]:
                raise AssertionError(f"time --batch {b} never launched "
                                     f"{name}")
        log(f"time --batch {b}: {json.dumps(out['p50_ms_per_stage'])}; "
            f"full_forward {out['full_forward_ms']} ms, full_train_step "
            f"{out['full_train_step_ms']} ms, fused_train_step "
            f"{out['fused_train_step_ms']} ms [{card}]")
    # the recipe's train net, its data layer as deploy-style inputs
    text = net_prototxt_from_config(dataclasses.replace(V4, vocab_size=VOCAB),
                                    batch_size=BATCH)
    lines = text.split("\n", 2)      # the data layer takes two lines
    if 'type: "HDF5Data"' not in lines[0]:
        raise AssertionError(f"unexpected data layer {lines[0]}")
    inputs = ('layer { name: "data" type: "Input" top: "question" top: '
              '"answer" top: "label" top: "overlap_feat" input_param { '
              f'shape {{ dim: {BATCH} dim: {W1} }} shape {{ dim: {BATCH} '
              f'dim: {W2} }} shape {{ dim: {BATCH} }} shape {{ dim: {BATCH} '
              'dim: 2 } } }\n')
    (tmp / "v4_deploy.prototxt").write_text(inputs + lines[2])
    before = dict(sk.LAUNCH_COUNTS)
    out = json.loads(run_cli(["time", "--model",
                              str(tmp / "v4_deploy.prototxt"), "--iters",
                              "10"])[-1])
    if "full_forward_backward_ms" not in out or \
            sk.LAUNCH_COUNTS["pair_maps_bwd_w"] <= before["pair_maps_bwd_w"]:
        raise AssertionError(f"time --model timed no backward: {out}")
    log(f"time --model (V4 recipe net, batch {BATCH}): {json.dumps(out)} "
        f"[{card}]")
    before = dict(sk.LAUNCH_COUNTS)
    out = json.loads(run_cli(["time", "--serve-pool", str(POOL),
                              "--pool-dtype", "int8", "--iters", "10"])[-1])
    if sk.LAUNCH_COUNTS["maxsim_int8"] <= before["maxsim_int8"]:
        raise AssertionError("time --serve-pool never launched maxsim_int8")
    log(f"time --serve-pool {POOL} int8: {json.dumps(out)} [{card}]")


def _tail_export(sk, params, state, cfg, card: str, tmp: Path) -> None:
    """A scorer exported on the card, loaded, called at
    TAIL_EXPORT_BATCHES: within 1e-5 of the live model's max |logit|, one
    pair_maps_fwd launch a call."""
    from mms_answer_selection_tpu_torch import deploy
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_apply

    path = str(tmp / "v4.mmst")
    t0 = time.perf_counter()
    header = deploy.save_scorer(path, params, state, cfg)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scorer = deploy.load_scorer(path)
    load_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for n in TAIL_EXPORT_BATCHES:
        batch = {"question": torch.randint(0, VOCAB, (n, W1), generator=g,
                                           device="cuda"),
                 "answer": torch.randint(0, VOCAB, (n, W2), generator=g,
                                         device="cuda"),
                 "overlap_feat": torch.rand((n, 2), generator=g,
                                            device="cuda")}
        before = sk.LAUNCH_COUNTS["pair_maps_fwd"]
        logits, _ = scorer(batch["question"], batch["answer"],
                           batch["overlap_feat"])
        if sk.LAUNCH_COUNTS["pair_maps_fwd"] != before + 1:
            raise AssertionError("the loaded scorer did not launch "
                                 "pair_maps_fwd once")
        with torch.no_grad():
            want = mms_qa_apply(params, state, batch, cfg,
                                train=False)[0]["logits"].cpu()
        err = float((torch.as_tensor(logits) - want).abs().max())
        if err > 1e-5 * float(want.abs().max()):
            raise AssertionError(f"exported scorer at batch {n}: {err}")
        log(f"export: batch {n} logits within {err:.3g} of the live model "
            f"(max |logit| {float(want.abs().max()):.4g})")
    log(f"export: {header['bytes']} program bytes, saved in {save_s:.3f} s, "
        f"loaded in {load_s:.3f} s, torch {header['torch']} [{card}]")


def _tail_bf16(params, state, cfg, card: str) -> None:
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_apply

    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    batch = {"question": torch.randint(0, VOCAB, (1024, W1), generator=g,
                                       device="cuda"),
             "answer": torch.randint(0, VOCAB, (1024, W2), generator=g,
                                     device="cuda"),
             "overlap_feat": torch.rand((1024, 2), generator=g,
                                        device="cuda")}
    with torch.no_grad():
        f32 = mms_qa_apply(params, state, batch, cfg, train=False)[0]
        b16 = mms_qa_apply(params, state, batch, cfg, train=False,
                           compute_dtype=torch.bfloat16)[0]
    diff = float((f32["prob"] - b16["prob"]).abs().max())
    moved = float((f32["logits"] - b16["logits"]).abs().max())
    lo, hi = TAIL_BF16_P_BAND
    if not lo <= diff <= hi:
        raise AssertionError(f"bf16 compute moved P by {diff}, outside "
                             f"{TAIL_BF16_P_BAND}")
    log(f"compute_dtype bf16 at batch 1024: max |P - P_f32| {diff!r}, max "
        f"|logits - logits_f32| {moved!r} (band {TAIL_BF16_P_BAND}) "
        f"[{card}]")


def _tail_parallel(cfg, splits, serve_params, card: str) -> list:
    """TAIL_STEPS steps of the recipe on the corpus through the plain
    Trainer and through Trainer(mesh=) over one NCCL rank (bit for bit);
    then two gloo ranks sharing the card (``tail_rank``): the same steps
    over dp = 2 (STEP_TOL), one tp = 2 step against the unsharded one,
    and a split POOL-candidate pool against one process (bit for bit).
    Step p50s in turns with the plain step's."""
    import numpy as np
    import torch.distributed as dist

    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_init
    from mms_answer_selection_tpu_torch.parallel import make_mesh
    from mms_answer_selection_tpu_torch.parallel.launch import spawn
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    train = splits["train"]
    keys = ("question", "answer", "label", "overlap_feat")
    batches = [{k: np.asarray(train[k][i * BATCH:(i + 1) * BATCH])
                for k in keys} for i in range(TAIL_STEPS)]
    # a random W: from the recipe's W = 0 the first step's scores are
    # near-ties that rounding orders, and runs summing in another order
    # part at once
    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        SEED), device="cuda")
    params["sim"]["w"] = torch.randn(
        params["sim"]["w"].shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED)) * 0.05
    p_np, s_np = _tail_numpy(params), _tail_numpy(state)

    # bit for bit needs the card's deterministic algorithms in both runs
    # (the embedding gradient's scatter otherwise sums in the order its
    # atomics land)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            plain = _tail_dp_run(_tail_trainer(cfg), p_np, s_np, batches, 0)
            again = _tail_dp_run(_tail_trainer(cfg), p_np, s_np, batches, 0)
            mesh = make_mesh(1, devices="cuda")      # one NCCL rank
            world1 = _tail_dp_run(_tail_trainer(cfg, mesh), p_np, s_np,
                                  batches, 0)
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("the one-rank mesh is not one NCCL rank")
        for name, run in (("plain again", again), ("world 1", world1)):
            if plain["losses"] != run["losses"] or not all(
                    torch.equal(a, b) for (_, a), (_, b) in
                    zip(_tail_named(plain["params"]),
                        _tail_named(run["params"]))):
                raise AssertionError(f"{name} is not the plain Trainer's "
                                     f"run bit for bit")
        one_tp = _tail_sharded_step(p_np, s_np, batches[0], TAIL_TIMED_STEPS,
                                    mesh)
    finally:
        dist.destroy_process_group()
    log(f"dp: Trainer(mesh=make_mesh(1)) over one NCCL rank = the plain "
        f"Trainer bit for bit over {TAIL_STEPS} steps (losses "
        f"{plain['losses'][0]:.6f} -> {plain['losses'][-1]:.6f})")

    plain_trainer = _tail_trainer(cfg)
    before = statistics.median(_tail_dp_run(
        plain_trainer, p_np, s_np, batches, TAIL_TIMED_STEPS)["step_ms"])
    g = torch.Generator().manual_seed(SEED + 13)
    queries = torch.randint(0, VOCAB, (N_QUERIES, W1), generator=g)
    ranks = spawn("chip_smoke:tail_rank", 2, backend="gloo",
                  pythonpath=[str(ROOT)], timeout=600, share_device=True,
                  kwargs={"params": p_np, "state": s_np, "batches": batches,
                          "serve_params": _tail_numpy(serve_params),
                          "queries": queries.numpy()})
    after = statistics.median(_tail_dp_run(
        plain_trainer, p_np, s_np, batches, TAIL_TIMED_STEPS)["step_ms"])
    want = {"dp": CLI_TRAIN_KERNELS, "tp": CLI_TRAIN_KERNELS,
            "int8": ("maxsim_int8",), "bf16": ("maxsim_bf16",)}
    for r, rank in enumerate(ranks):
        for part, names in want.items():
            for name in names:
                if rank["launches"][part].get(name, 0) < 1:
                    raise AssertionError(f"rank {r} never launched {name} "
                                         f"in its {part} part")

    band = 2 * TAIL_STEPS * 2 * ADADELTA_STEP
    for r, rank in enumerate(ranks):
        for a, b in zip(rank["dp"]["losses"], plain["losses"]):
            if abs(a - b) > STEP_ATOL + STEP_RTOL * abs(b):
                raise AssertionError(f"dp=2 rank {r} loss {a} vs {b}")
        worst = _tail_close(rank["dp"]["params"], plain["params"], band,
                            f"dp=2 rank {r}")
    log(f"dp: 2 gloo ranks on one card, global batch {BATCH}: {TAIL_STEPS} "
        f"steps within rtol {STEP_RTOL} / atol {STEP_ATOL} of the one-rank "
        f"run (params {worst:.3g} of their max apart, conv biases within "
        f"AdaDelta's band); step p50 "
        f"{statistics.median(ranks[0]['dp']['step_ms']):.3f} ms against "
        f"the plain step's {before:.3f} / {after:.3f} ms before / after "
        f"[{card}]")

    tp = sorted((r["tp"] for r in ranks), key=lambda r: r["tp_rank"])
    if tp[0]["params"]["embed"]["w"].shape[0] * 2 != VOCAB:
        raise AssertionError("tp = 2 did not split the embedding rows")
    joined = {k: {kk: (torch.cat([r["params"][k][kk] for r in tp])
                       if tp[0]["params"][k][kk].shape != vv.shape
                       else tp[0]["params"][k][kk]) for kk, vv in v.items()}
              for k, v in one_tp["params"].items()}
    for r in tp:
        if abs(r["loss"] - one_tp["loss"]) > STEP_ATOL + STEP_RTOL * abs(
                one_tp["loss"]):
            raise AssertionError(f"tp=2 loss {r['loss']} vs "
                                 f"{one_tp['loss']}")
    worst = _tail_close(joined, one_tp["params"], 2 * 2 * ADADELTA_STEP,
                        "tp=2")
    log(f"tp: one sharded step, tp = 2 over 2 gloo ranks on one card, "
        f"equals the unsharded step (loss {one_tp['loss']:.6f}; params "
        f"{worst:.3g} of their max apart); step p50 "
        f"{statistics.median(tp[0]['step_ms']):.3f} ms against the "
        f"unsharded {statistics.median(one_tp['step_ms']):.3f} ms [{card}]")

    for pd in TAIL_ENGINES:
        eng = QueryEngine(serve_params, cfg, pool_dtype=pd, chunk_size=CHUNK,
                          device="cuda").build_index(_tail_pool(cfg))
        q = queries.to("cuda")
        vals, idx = eng.query(q, k=K)
        one_ms = sync_ms(lambda: eng.query(q, k=K), 10)
        vals, idx = vals.cpu(), idx.cpu()
        for r, rank in enumerate(ranks):
            v, i, _ = rank[pd]
            if not (torch.equal(i, idx) and torch.equal(
                    v.view(torch.int32), vals.view(torch.int32))):
                raise AssertionError(f"{pd}: rank {r}'s merged top-{K} is "
                                     f"not the one-process engine's")
        log(f"serve {pd} at {POOL} over 2 gloo ranks: top-{K} of "
            f"{N_QUERIES} queries = one process, ids and values bit for "
            f"bit; query p50 {ranks[0][pd][2]:.3f} ms against one "
            f"process's {one_ms:.3f} ms [{card}]")
        del eng
        torch.cuda.empty_cache()
    return [r["launches"] for r in ranks]


TAIL_DEPLOY = """
name: "deploy" force_backward: true
input: "data" input_shape { dim: 8 dim: 3 dim: 16 dim: 16 }
layer { type: "Convolution" name: "conv" bottom: "data" top: "conv"
  convolution_param { num_output: 16 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layer { type: "ReLU" name: "relu" bottom: "conv" top: "relu" }
layer { type: "Pooling" name: "pool" bottom: "relu" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { type: "InnerProduct" name: "ip" bottom: "pool" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { type: "Softmax" name: "prob" bottom: "ip" top: "prob" }
"""
TAIL_TRAIN = """
name: "train"
layer { type: "DummyData" name: "data" top: "data" top: "label"
  dummy_data_param { num: 16 channels: 3 height: 16 width: 16
    num: 16 channels: 1 height: 1 width: 1
    data_filler { type: "constant" value: 0.5 }
    data_filler { type: "constant" value: 3 } } }
layer { type: "Convolution" name: "conv" bottom: "data" top: "conv"
  convolution_param { num_output: 8 kernel_size: 3
    weight_filler { type: "xavier" } } }
layer { type: "InnerProduct" name: "ip" bottom: "conv" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { type: "SoftmaxWithLoss" name: "loss" bottom: "ip" bottom: "label"
  top: "loss" }
"""


def _tail_matbridge(card: str, tmp: Path) -> None:
    """`cli matbridge` in its own process on localhost, driven by the
    wire protocol's client, its replies held to the same calls on
    in-process pycaffe objects."""
    import numpy as np

    from mms_answer_selection_tpu_torch import caffe_compat as caffe
    from mms_answer_selection_tpu_torch.matcaffe import MatClient, from_mat

    (tmp / "deploy.prototxt").write_text(TAIL_DEPLOY)
    (tmp / "train.prototxt").write_text(TAIL_TRAIN)
    (tmp / "solver.prototxt").write_text(
        f'net: "{tmp / "train.prototxt"}" base_lr: 0.05 momentum: 0.9 '
        'lr_policy: "fixed" display: 0 max_iter: 100 random_seed: 5 '
        'snapshot_after_train: false')
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mms_answer_selection_tpu_torch.cli",
         "matbridge", "--port", "0"], cwd=str(ROOT), stdout=subprocess.PIPE,
        text=True)
    try:
        first = json.loads(proc.stdout.readline())
        client = MatClient("127.0.0.1", first["matbridge"]["port"])
        rng = np.random.default_rng(SEED)
        x = rng.normal(size=(16, 16, 3, 8)).astype(np.float32)  # W H C N
        h = client("get_net", str(tmp / "deploy.prototxt"), "test")
        attr = client("net_get_attr", h)
        names = attr["blob_names"]
        client("blob_set_data", attr["hBlob_blobs"][names.index("data")], x)
        client("net_forward", h)
        prob = client("blob_get_data",
                      attr["hBlob_blobs"][names.index("prob")])
        client("net_save", h, str(tmp / "bridge.caffemodel"))
        hs = client("get_solver", str(tmp / "solver.prototxt"))
        client("solver_step", hs, 10)
        it = client("solver_get_iter", hs)
        snet = client("solver_get_attr", hs)["hNet_net"]
        sattr = client("net_get_attr", snet)
        client("net_forward", snet)
        loss = client("blob_get_data", sattr["hBlob_blobs"][
            sattr["blob_names"].index("loss")])
        client("shutdown")
        client.close()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    caffe.set_mode_gpu()
    net = caffe.Net(str(tmp / "deploy.prototxt"), caffe.TEST)
    net.forward(data=np.ascontiguousarray(from_mat(x).transpose(0, 2, 3, 1)))
    want = np.asarray(net.blobs["prob"].data)
    err = float(np.abs(from_mat(prob) - want).max())
    net.save(str(tmp / "inproc.caffemodel"))
    if err > 1e-6 or (tmp / "bridge.caffemodel").read_bytes() != \
            (tmp / "inproc.caffemodel").read_bytes():
        raise AssertionError(f"matbridge forward / save differ ({err})")
    solver = caffe.get_solver(str(tmp / "solver.prototxt"))
    solver.step(10)
    solver.net.forward()
    want_loss = float(solver.net.blobs["loss"].data)
    if it != 10 or abs(float(from_mat(loss).ravel()[0]) - want_loss) > \
            1e-5 * max(abs(want_loss), 1.0):
        raise AssertionError(f"matbridge solver: iter {it}, loss "
                             f"{from_mat(loss)} vs {want_loss}")
    log(f"matbridge: cli matbridge on localhost answered get_net, "
        f"blob_set_data, net_forward, blob_get_data (P within {err:.3g}), "
        f"net_save (the same bytes), get_solver, solver_step 10 (loss "
        f"{want_loss:.6f}) as the in-process pycaffe objects do, in "
        f"{time.perf_counter() - t0:.3f} s [{card}]")


def _tail_plot(tmp: Path, losses) -> None:
    """`plot` charts 0 and 6 from a log in the reference's format, or, on a
    host without matplotlib, its refusal."""
    import importlib.util

    lines = ["I0101 00:00:00.000000  1 solver.cpp:1] Solving net"]
    for i, loss in enumerate(losses):
        stamp = f"I0101 00:00:{i:02d}.000000  1"
        if i % 5 == 0:
            lines += [f"{stamp} solver.cpp:2] Iteration {i}, Testing net "
                      f"(#0)", f"{stamp} solver.cpp:3]     Test net output "
                      f"#0: accuracy = {1.0 - loss / 2:.6f}"]
        lines += [f"{stamp} solver.cpp:4] Iteration {i}, loss = {loss}",
                  f"{stamp} sgd_solver.cpp:6] Iteration {i}, lr = 1"]
    (tmp / "train.log").write_text("\n".join(lines) + "\n")
    if importlib.util.find_spec("matplotlib") is None:
        try:
            run_cli(["plot", "6", str(tmp / "loss.png"),
                     str(tmp / "train.log")])
        except SystemExit as e:
            if "matplotlib" not in str(e) or (tmp / "loss.png").exists():
                raise
        else:
            raise AssertionError("plot without matplotlib returned")
        log("plot: skipped, this host has no matplotlib (the command exits "
            "with its message and draws nothing)")
        return
    for chart in (0, 6):
        run_cli(["plot", str(chart), str(tmp / f"c{chart}.png"),
                 str(tmp / "train.log")])
        if not (tmp / f"c{chart}.png").stat().st_size:
            raise AssertionError(f"plot {chart} drew nothing")
    log("plot: charts 0 and 6 drawn")


def tail_phase(dev, card: str, splits) -> dict:
    """The rest of the JAX package's surface on the card at V4's full width
    (D = 50, W1 = W2 = 40, M = 4, vocab VOCAB): `time`, `export`, the bf16
    forward, dp and tp training over torch.distributed, the split serving
    pool, the matcaffe bridge and `plot`.  Returns the launches of the
    path, counted from 0, this process's and under "ranks" each spawned
    rank's, part by part."""
    import tempfile

    import numpy as np

    from mms_answer_selection_tpu_torch.models.mms_qa import MMSQAConfig
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    t0 = time.perf_counter()
    cfg = MMSQAConfig(vocab_size=VOCAB)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    params, state = random_model(
        cfg, lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev)
        * scale, gen, dev)
    for name in sk.LAUNCH_COUNTS:
        sk.LAUNCH_COUNTS[name] = 0
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        _tail_time(sk, card, tmp)
        _tail_export(sk, params, state, cfg, card, tmp)
        _tail_bf16(params, state, cfg, card)
        ranks = _tail_parallel(cfg, splits, params, card)
        _tail_matbridge(card, tmp)
        _tail_plot(tmp, np.linspace(0.7, 0.4, TAIL_STEPS))
    launches = dict(sk.LAUNCH_COUNTS)
    for name in (*CLI_TRAIN_KERNELS, "maxsim_int8", "maxsim_bf16"):
        if launches[name] < 1:
            raise AssertionError(f"the tail path never launched {name}")
    launches["ranks"] = ranks
    log(f"tail phase: {time.perf_counter() - t0:.1f} s")
    return launches



# the examples' twins (mms_answer_selection_tpu_torch/examples), each called
# through its main() at the JAX script's defaults but where noted, and the
# kernels each must launch.  ``retrieval_1m`` also runs IVF and the coarse
# shortlist over a bf16 pool of POOL candidates.
EXAMPLE_RUNS = (  # (label, module, argv, kernels it must launch)
    ("recipe_scale_rehearsal --hard", "recipe_scale_rehearsal", ("--hard",),
     CLI_TRAIN_KERNELS),
    ("trec_qa_mms", "trec_qa_mms", (), (*CLI_TRAIN_KERNELS, "maxsim_bf16")),
    ("retrieval_1m", "retrieval_1m", (), ("maxsim_int8",)),
    ("retrieval_1m --ivf-clusters", "retrieval_1m",
     ("--pool", str(POOL), "--ivf-clusters", "1024", "--coarse-shortlist",
      "1024"), ("maxsim_bf16",)),
    ("serve_load", "serve_load", (), ("maxsim_int8",)),
    ("int8_error_analysis", "int8_error_analysis", (),
     ("maxsim_int8", "maxsim_bf16")),
    ("pair_image_metric", "pair_image_metric", (), ()),
)


def _check_example(name: str, out: dict) -> str:
    """The example's own result, read as the repo reads it; returns a
    one-line summary."""
    import math

    if name == "recipe_scale_rehearsal":
        # the twin asserted trec_eval = numpy = in-graph and its min gain
        if out["backend"] != "cuda":
            raise AssertionError(f"the recipe ran on {out['backend']}")
        return (f"dev MAP {out['chance_dev_map_step0']:.4f} -> "
                f"{out['best_dev_map']:.4f} @ {out['best_step']}, test MAP "
                f"/ MRR {out['test_map']:.4f} / {out['test_mrr']:.4f}, "
                f"fit {out['fit_s']} s, last eval {out['last_eval_step']}")
    if name == "trec_qa_mms":
        if not (0.0 <= out["test_map"] <= 1.0
                and len(out["retrieval_top5"]) == 3):
            raise AssertionError(f"trec_qa_mms gave {out}")
        return (f"test MAP / MRR {out['test_map']:.4f} / "
                f"{out['test_mrr']:.4f}, best dev MAP "
                f"{out['best_dev_map']:.4f} @ {out['best_step']}")
    if name == "retrieval_1m":
        scores = [v for _, v in out["top_k_query0"]]
        if not (len(scores) == K and all(map(math.isfinite, scores))
                and scores == sorted(scores, reverse=True)):
            raise AssertionError(f"retrieval_1m's top-k: {scores}")
        line = (f"{out['pool_dtype']} {out['queries']} q x {out['pool']}: "
                f"{out['query_ms']:.3f} ms ({out['pairs_per_s']:.4g} "
                f"pairs/s), index {out['index_s']:.3f} s")
        for mode in ("ivf", "coarse"):
            if mode in out:
                line += (f"; {mode} 1 q {out[mode]['ms']:.3f} ms, "
                         f"recall@10 {out[mode]['recall@10']:.3f}")
        return line
    if name == "serve_load":
        for label in ("unbatched", "batched"):
            if out[label]["device_dispatches"] < 1:
                raise AssertionError(f"serve_load {label}: {out[label]}")
        return "; ".join(
            f"{label} {out[label]['req_per_s']:.1f} req/s p50 "
            f"{out[label]['p50_ms']:.3f} ms p99 {out[label]['p99_ms']:.3f} "
            f"ms, {out[label]['rows_per_dispatch']:.2f} rows a dispatch"
            for label in ("unbatched", "batched"))
    if name == "int8_error_analysis":
        for pool in (POOL, BIG_POOL):
            row = out[f"pool_{pool}"]
            # the bf16 top-10 within an int8 shortlist of 512
            if not (row["top10_agreement"] > 0.5
                    and row["recall10_in_s"]["512"] >= 0.99):
                raise AssertionError(f"int8 at {pool}: {row}")
        sizes = {k: v for k, v in out["guidance"].items() if k != "rule"}
        return (f"sigma {out['per_pair_error']['sigma']:.4f}; top-10 "
                f"agreement {out[f'pool_{POOL}']['top10_agreement']:.4f} / "
                f"{out[f'pool_{BIG_POOL}']['top10_agreement']:.4f}, "
                f"shortlists {json.dumps(sizes)}")
    if name == "pair_image_metric":
        if not (math.isfinite(out["final_loss"])
                and out["final_loss"] < out["loss"][0]):
            raise AssertionError(f"pair_image_metric's loss: {out}")
        return f"loss {out['loss'][0]:.4f} -> {out['final_loss']:.4f}"
    raise KeyError(name)


def examples_phase(card: str) -> dict:
    """The JAX package's examples as the port's twins, on the card, each
    through its ``main``: the recipe with ``--hard`` (3,001 steps,
    patience 5, its own trec_eval parity and 0.25 min-gain asserts),
    ``trec_qa_mms`` in smoke mode, ``retrieval_1m`` at 1,048,576 int8 and
    at POOL with IVF and the coarse shortlist, ``serve_load``, the full
    int8 error analysis into a temporary directory and
    ``pair_image_metric``.  Logs each one's wall and launches and fails
    unless each launched its kernels; returns the launches, example by
    example."""
    import contextlib
    import importlib
    import io
    import tempfile

    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as td:
        for label, name, argv, kernels in EXAMPLE_RUNS:
            mod = importlib.import_module(
                f"mms_answer_selection_tpu_torch.examples.{name}")
            argv = list(argv)
            kw = {}
            if name == "int8_error_analysis":
                kw["out_dir"] = f"{td}/int8"
            elif name in ("recipe_scale_rehearsal", "trec_qa_mms"):
                argv += ["--out", f"{td}/{name}"]
            elif name == "pair_image_metric":
                argv += ["--dir", f"{td}/pairs"]
            for k in sk.LAUNCH_COUNTS:
                sk.LAUNCH_COUNTS[k] = 0
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                out = mod.main(argv, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(sk.LAUNCH_COUNTS)
            launches[label] = got
            log(f"example {label}: {wall:.1f} s, launches "
                f"{json.dumps({k: v for k, v in got.items() if v})}; "
                f"{_check_example(name, out)} [{card}]")
            for kernel in kernels:
                if got[kernel] < 1:
                    raise AssertionError(f"example {label} never launched "
                                         f"{kernel}")
            torch.cuda.empty_cache()
    log(f"examples phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


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

    serve_dispatch_phase(params, state, cfg, engines, queries, dev, card)

    # ------------------------------------------- lifecycle, IVF, 1M pools
    lifecycle_phase(params, state, cfg, cand_ids, queries, dev)
    ivf_phase(params, cfg, gen, dev, card)

    # ------------------------------------------------------------- training
    train_launches, splits, info = train_phase(dev, normal, card, max_err,
                                               timed)
    launches.update({k: train_launches[k] for k in KERNELS
                     if k not in MAXSIM})
    dispatch = dispatch_phase(dev, card, splits, info)
    cli_phase(dev, card)
    graph = graph_phase(dev, card, splits, info)
    pycaffe = pycaffe_phase(dev, card, splits, info)
    tail = tail_phase(dev, card, splits)
    del splits, info

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
    torch.cuda.empty_cache()
    mm = multimodal_phase(sk, normal, dev, card, max_err)
    torch.cuda.empty_cache()
    examples = examples_phase(card)
    log(f"launches on the dispatch path: {json.dumps(dispatch)}")
    log(f"launches on the generic path: {json.dumps(graph)}")
    log(f"launches on the pycaffe path: {json.dumps(pycaffe)}")
    log(f"launches on the multimodal path: {json.dumps(mm)}")
    log(f"launches on the tail path: {json.dumps(tail)}")
    log(f"launches on the examples' paths: {json.dumps(examples)}")
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
