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
* ``span(name)`` / ``count(name)``: the program's own spans and counters,
  kept by a ``Recorder`` (``default``, the process's; a ``QAServer`` keeps
  its own).  Spans sit at the boundaries that happen once a chunk, an
  eval, a call, a capture, a request or a build, never once a step and
  never inside a captured region.

A span records its name, start and end, its parent (the span open around
it in the same thread and recorder), the id of its unit of work (given,
else its parent's, else its own sequence number) and its self time: its
duration less what its child spans cover.  With no profiler running a
span only updates its name's aggregate: count, total, self total and a
histogram of durations in log buckets 2% wide, over every span since
start.  While a ``torch.profiler`` session runs (``trace``, a benchmark's
traced window) each span is also kept whole (``Recorder.spans``) and
mirrored as a ``record_function`` of its name, so the profiler's host
timeline carries it beside the device's kernels.  The spans kept whole
are those of the latest session: the first span opened under a profiler
after one opened with none running starts the list anew.  Spans are
stamped on the Unix clock in nanoseconds, the clock the profiler stamps
its host events with.  A span left by an exception joins no aggregate.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time

import numpy as np
import torch

from ..utils.tree import tree_leaves

# a bucket holds durations within a factor of _RATIO: 2% wide
_RATIO = 1.02
_LOG_RATIO = math.log(_RATIO)
# the monotonic clock shifted once onto the Unix clock
_UNIX_NS = time.time_ns() - time.perf_counter_ns()
_profiling = torch._C._autograd._profiler_enabled


class Aggregate:
    """One span name's durations since its recorder started: count, total
    and self total, least and most, and how many fell in each log bucket
    (so no sample is dropped, whatever the run's length)."""

    __slots__ = ("count", "total_ns", "self_ns", "min_ns", "max_ns",
                 "buckets")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.min_ns = self.max_ns = None
        self.buckets: dict = {}

    def add(self, ns: int, self_ns: int) -> None:
        self.count += 1
        self.total_ns += ns
        self.self_ns += self_ns
        self.min_ns = ns if self.min_ns is None else min(self.min_ns, ns)
        self.max_ns = ns if self.max_ns is None else max(self.max_ns, ns)
        b = int(math.log(max(ns, 1)) / _LOG_RATIO)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def copy(self) -> "Aggregate":
        out = Aggregate()
        out.count, out.total_ns, out.self_ns = (self.count, self.total_ns,
                                                self.self_ns)
        out.min_ns, out.max_ns = self.min_ns, self.max_ns
        out.buckets = dict(self.buckets)
        return out

    @property
    def total_s(self) -> float:
        return self.total_ns / 1e9

    @property
    def self_s(self) -> float:
        return self.self_ns / 1e9

    def quantile(self, q: float) -> float:
        """Seconds of the sample at rank ``min(count - 1, int(count *
        q))`` in ascending order, to within 1%: its bucket's geometric
        middle, kept between the least and most durations seen."""
        rank = min(self.count - 1, int(self.count * q))
        for b in sorted(self.buckets):
            rank -= self.buckets[b]
            if rank < 0:
                ns = _RATIO ** (b + 0.5)
                return min(max(ns, self.min_ns), self.max_ns) / 1e9
        raise ValueError("no spans")


class Span:
    """An open span (a context manager), then its record: ``name``,
    ``start_ns`` and ``end_ns`` on the Unix clock, ``seq`` (its own
    number), ``parent`` (the enclosing span's ``seq``, or None), ``id``
    (its unit of work) and ``self_ns``."""

    __slots__ = ("_rec", "_mirror", "_child_ns", "name", "id", "seq",
                 "parent", "start_ns", "end_ns")

    def __init__(self, rec: "Recorder", name: str, id):
        self._rec = rec
        self.name, self.id = name, id
        self._mirror = None
        self._child_ns = 0
        self.seq = next(rec._seq)
        self.parent = None
        self.start_ns = self.end_ns = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self._child_ns

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = rec._stack()
        if stack:
            up = stack[-1]
            self.parent = up.seq
            if self.id is None:
                self.id = up.id
        if self.id is None:
            self.id = self.seq
        stack.append(self)
        if _profiling():
            if not rec._session:
                rec._new_session()
            self._mirror = torch.autograd.profiler.record_function(self.name)
            self.start_ns = time.perf_counter_ns() + _UNIX_NS
            self._mirror.__enter__()
        else:
            rec._session = False
            self.start_ns = time.perf_counter_ns() + _UNIX_NS
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        mirror, self._mirror = self._mirror, None
        if mirror is not None:
            mirror.__exit__(exc_type, exc, tb)
        self.end_ns = time.perf_counter_ns() + _UNIX_NS
        stack = self._rec._stack()
        stack.pop()
        if stack:
            stack[-1]._child_ns += self.end_ns - self.start_ns
        if exc_type is None:
            self._rec._close(self, mirror is not None)
        return False


class Recorder:
    """Spans' aggregates and counters by name, and while a profiler runs
    the spans themselves (module docstring).  Safe across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = itertools.count()
        self._aggregates: dict = {}
        self._counters: dict = {}
        self._spans: list = []
        # the last span opened found a profiler running
        self._session = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_session(self) -> None:
        with self._lock:
            self._spans = []
            self._session = True

    def _close(self, span: Span, whole: bool) -> None:
        with self._lock:
            agg = self._aggregates.get(span.name)
            if agg is None:
                agg = self._aggregates[span.name] = Aggregate()
            agg.add(span.end_ns - span.start_ns, span.self_ns)
            if whole:
                self._spans.append(span)

    def span(self, name: str, id=None) -> Span:
        """A span of ``name`` around a ``with`` block; ``id``: its unit of
        work (default: the enclosing span's, else its own ``seq``)."""
        return Span(self, name, id)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def aggregate(self, name: str) -> Aggregate | None:
        """A copy of the aggregate of the spans named ``name`` (other
        threads may be adding to it); None before one closed."""
        with self._lock:
            agg = self._aggregates.get(name)
            return None if agg is None else agg.copy()

    def spans(self) -> list:
        """The spans opened while the latest profiler session ran, in the
        order they closed."""
        with self._lock:
            return list(self._spans)


default = Recorder()


def span(name: str, id=None) -> Span:
    """A span of the process's recorder (``Recorder.span``)."""
    return default.span(name, id)


def count(name: str, n: int = 1) -> None:
    """A counter of the process's recorder."""
    default.count(name, n)


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
