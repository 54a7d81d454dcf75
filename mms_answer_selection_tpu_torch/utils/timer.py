"""Timing and profiling (counterpart of ``utils/timer.py``).

The reference's profiler is ``caffe time``: per-layer forward and backward
wall-clock over N iterations with CUDA-event timers
(tools/caffe.cpp:301-387, include/caffe/util/benchmark.hpp).  Here:

* ``benchmark(fn, *args)``: host wall-clock of ``fn`` with a completion
  fence (``torch.cuda.synchronize`` of the outputs' card), mean / p50 / p95
  / min over iterations after warm-up.
* ``stage_times`` / ``stage_times_fwd_bwd``: the ``caffe time`` table of
  the MMS model, stage by stage (embed, sim_cross, conv_block{i}, head),
  on the card timed by CUDA events around a burst of calls queued behind a
  sleeping kernel (the host's enqueue stays off the clock), on the CPU by
  the host clock.  ``sim_cross`` runs through the pair-map kernels.
* ``trace(path)``: a ``torch.profiler`` trace of the enclosed block,
  written as a Chrome trace to ``path``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..utils.tree import tree_leaves


def _fence(out):
    """Wait for the card that holds ``out``'s tensors; nothing on the CPU."""
    for leaf in tree_leaves(out) if isinstance(out, dict) else (
            list(out) if isinstance(out, (list, tuple)) else [out]):
        if torch.is_tensor(leaf) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


def benchmark(fn, *args, iters: int = 20, warmup: int = 3) -> dict:
    """Time fn(*args) with a completion fence after every call."""
    _fence(fn(*args))
    for _ in range(warmup):
        _fence(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "mean_s": float(arr.mean()),
        "p50_s": float(np.percentile(arr, 50)),
        "p95_s": float(np.percentile(arr, 95)),
        "min_s": float(arr.min()),
        "iters": iters,
    }


@contextlib.contextmanager
def trace(path: str):
    """A ``torch.profiler`` trace (host and, where there is a card, device
    activity) of the enclosed block, written to ``path`` as a Chrome trace
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def _device_of(tree) -> torch.device:
    return next(t.device for t in tree_leaves(tree) if torch.is_tensor(t))


def _burst_ms(fn, reps: int, device: torch.device) -> float:
    """One call's time in ms, the mean of a burst: ``reps`` warm calls
    between two CUDA events behind a sleeping kernel on the card (the host
    clock on the CPU), divided by ``reps``."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _stages(params, state, batch, cfg, train: bool):
    """[(name, leaves that take a gradient, fn(*leaves) -> output)] of the
    forward, each stage fed the previous stage's output."""
    from ..models.mms_qa import sim_map
    from ..ops import avg_pool2d, bn_apply, conv2d, embed_lookup, max_pool2d

    def head(f1, f2, x_, feat):
        flat = x_.reshape(x_.shape[0], -1)
        f = torch.cat([flat, feat.to(flat.dtype)], dim=1)
        h = torch.tanh(f @ f1["w"] + f1["b"])
        return h @ f2["w"] + f2["b"]

    out = []
    out.append(("embed", (params["embed"],),
                lambda ep: embed_lookup(ep, batch["question"])))
    with torch.no_grad():
        q = embed_lookup(params["embed"], batch["question"])
        a = embed_lookup(params["embed"], batch["answer"])
    sim = params.get("sim", {})
    out.append(("sim_cross", (sim, q, a),
                lambda sp, q_, a_: sim_map({**params, "sim": sp}, q_, a_,
                                           cfg)))
    with torch.no_grad():
        x = sim_map(params, q, a, cfg)
    for i, b in enumerate(cfg.blocks):
        def block(cp, bp, x_, i=i, b=b):
            y = conv2d(cp, x_)
            y, _ = bn_apply(bp, state[f"bn{i}"], y, train=train)
            pool = max_pool2d if b.pool == "max" else avg_pool2d
            return torch.tanh(pool(y, b.pool_k, b.pool_k,
                                   stride_h=b.pool_stride,
                                   stride_w=b.pool_stride))
        out.append((f"conv_block{i}", (params[f"conv{i}"], params[f"bn{i}"],
                                       x), block))
        with torch.no_grad():
            x = block(params[f"conv{i}"], params[f"bn{i}"], x)
    feat = batch["overlap_feat"]
    out.append(("head", (params["fc1"], params["fc2"], x),
                lambda f1, f2, x_: head(f1, f2, x_, feat)))
    return out


def _with_grad(inputs):
    """Copies of ``inputs`` (trees of tensors) that take a gradient, and
    their float leaves."""
    leaves = []

    def mark(t):
        if isinstance(t, dict):
            return {k: mark(v) for k, v in t.items()}
        if torch.is_tensor(t) and t.is_floating_point():
            t = t.detach().requires_grad_(True)
            leaves.append(t)
        return t

    return [mark(t) for t in inputs], leaves


def stage_times_fwd_bwd(params, state, batch, cfg, *,
                        iters: int = 10) -> dict:
    """Per-stage forward and backward times, the whole ``caffe time``
    report (tools/caffe.cpp:301-387 times each layer's forward and backward
    over the train net; BN runs in training mode, as there).

    Each stage's backward is timed directly: its forward runs once with
    autograd recording, and the burst times ``torch.autograd.grad`` of the
    output's sum with the graph kept (eager autograd holds the activations,
    so no forward is repeated; the JAX package subtracts a jitted forward
    from a jitted forward-and-backward instead).  Returns
    {stage: {"forward_ms", "backward_ms"}}."""
    dev = _device_of(params)
    results = {}
    for name, inputs, fn in _stages(params, state, batch, cfg, train=True):
        with torch.no_grad():
            fwd = _burst_ms(lambda: fn(*inputs), iters, dev)
        marked, leaves = _with_grad(inputs)
        y = fn(*marked)
        seed = torch.ones_like(y)
        bwd = _burst_ms(lambda: torch.autograd.grad(
            y, leaves, seed, retain_graph=True, allow_unused=True), iters,
            dev)
        results[name] = {"forward_ms": fwd, "backward_ms": bwd}
    return results


def stage_times(params, state, batch, cfg, *, iters: int = 10) -> dict:
    """Per-stage forward times of the MMS model in eval mode (hot-spot
    attribution): {stage: ``benchmark``'s dict}."""
    results = {}
    for name, inputs, fn in _stages(params, state, batch, cfg, train=False):
        with torch.no_grad():
            results[name] = benchmark(fn, *inputs, iters=iters)
    return results
