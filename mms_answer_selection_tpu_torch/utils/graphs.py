"""One dispatch a call: a no-grad function of static inputs as one CUDA
graph replay (the counterpart of the JAX package's ``jax.jit`` of its
serving programs and of its eval step).

``GraphedCall`` keeps, per key, static input buffers, a graph and its
static outputs.  Before each call the inputs are copied into the key's
buffers; the graph then replays the kernels its capture recorded, with no
Python between them, and the outputs are cloned before they are returned
(the next replay of the key overwrites them).  A key is the caller's
(the path and the Python ints its function closes over), the inputs' tree
structure, shapes and dtypes, and the addresses of the tensors the
function reads in place (``fixed``).  An owner whose state the functions
read otherwise (an engine's pool and index) calls ``drop`` whenever that
state changes: a new version of it, which no old graph may read.

A key is captured the first time it runs: one call of the function on a
side stream first (outputs discarded; it loads the kernels' library,
makes the kernels' first attribute calls and lets cuBLAS and cuDNN set
up), then ``torch.cuda.graph`` around a second, so a function must not
write what it reads (the caller applies such updates to the outputs).
A capture that fails (a host sync, a copy from the host) raises, naming
the line it started at; nothing falls back to eager calls, and the next
capture takes a fresh pool (the failed one stays marked as recording).  The graphs of one ``GraphedCall``
share one memory pool, which is safe because its replays never overlap
(callers serialise them) and every graph's static outputs stay referenced
until the key is dropped: a replay rewrites only the memory its own
capture allocated or freed, and each result is cloned before the next
replay.

A function with random layers takes ``generators=``: one seed a
generator.  Each key keeps its own generators on the device, registered
with its graph at capture and seeded on the host before every call (a
replay, or an eager call), so a replay draws what an eager call on fresh
generators seeded so would draw.  The function receives them as its
keyword ``generators``.  Keys that pass none behave as if the argument
did not exist.

On the CPU, over a gloo mesh (whose collectives wait on the host;
``captures_on``), and where the caller asks for no capture, the same
function runs eagerly on the same static buffers, so the keying and
invalidation run there too.

A function that runs collectives over an NCCL mesh is given it
(``mesh=``): its collectives are captured with it, and every rank must
warm up, capture and replay at the same call, since a rank that captured
while another replayed would run a different sequence of collectives, and
both would hang.  So a meshed call's key holds nothing rank-local: the
caller's key and the inputs' structure, shapes and dtypes, which every
rank gives alike, and no ``fixed`` addresses (refused).  Every rank then
finds or misses each key at the same call and captures with the others,
with no vote; the owner calls ``drop`` on every rank at the same point (on
a change every rank makes).  A function without collectives takes no
``mesh`` and may key on addresses, so one rank may call it alone.
Captures run in ``thread_local`` mode, so the calls the NCCL watchdog
thread makes on its events during a capture (and a server's other
threads) do not invalidate it.

The kernels' wrappers count their launches in Python, which a replay never
runs: a capture's increments are taken back (nothing ran), kept as the
graph's tally, and added once per replay.  ``kernel_nodes`` reads what a
captured graph launches from the graph itself (its DOT print).
"""

from __future__ import annotations

import gc
import logging
import os
import re
import tempfile
import traceback
from typing import Callable

import torch

from ..ops import sim_cross_kernels as sk
from .timer import span

log = logging.getLogger("mms_tpu_torch.graphs")


def record_tally(counts: dict, body: Callable[[], None]) -> dict:
    """Run ``body`` (a capture) and take back the launches it counted in
    ``counts``; returns them (the graph's tally), name -> launches."""
    before = dict(counts)
    try:
        body()
    finally:
        tally = {k: counts[k] - before[k] for k in counts
                 if counts[k] != before[k]}
        counts.update(before)
    return tally


def add_tally(counts: dict, tally: dict) -> None:
    """Count one replay of a graph whose tally is ``tally``."""
    for k, v in tally.items():
        counts[k] += v


def _origin(exc: BaseException) -> str:
    """The line of the captured code where a failed capture started: the
    innermost frame of the first exception in the chain."""
    while exc.__context__ is not None:
        exc = exc.__context__
    frames = traceback.extract_tb(exc.__traceback__)
    if not frames:
        return repr(exc)
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line}): {exc}"


_DOT_NODE = re.compile(r'(?m)^\s*"graph_\d+_node_\d+"\s*\[')


def count_kernel_nodes(dot: str, names) -> dict:
    """name -> the nodes of a graph's DOT print (``cudaGraphDebugDotPrint``)
    whose statement holds ``name``: with the kernel names, the kernel
    nodes launching each."""
    starts = [m.start() for m in _DOT_NODE.finditer(dot)] + [len(dot)]
    nodes = [dot[a:b] for a, b in zip(starts, starts[1:])]
    return {n: sum(n in node for node in nodes) for n in names}


def kernel_nodes(graph: torch.cuda.CUDAGraph, names) -> dict:
    """name -> the kernel nodes of a captured ``graph`` launching a kernel
    whose name holds ``name``, read from the graph itself: the CUDA
    driver's DOT print of it (``debug_dump``), so the graph must keep its
    node list (``CUDAGraph(keep_graph=True)``, then ``instantiate()`` after
    the capture).  The dump may release the node list (the instantiated
    graph replays on), so read a graph once."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("the graph wrote no DOT print: it kept no "
                               "node list (keep_graph=True)")
        with open(path) as f:
            return count_kernel_nodes(f.read(), names)


def _flatten(tree, leaves: list):
    """The leaves of nested dicts and tuples into ``leaves``, as tensors
    (a numpy array or a list becomes one); returns the structure
    ``_unflatten`` takes.  None stays a structure of its own."""
    if isinstance(tree, dict):
        return ("dict", tuple(tree), tuple(_flatten(v, leaves)
                                           for v in tree.values()))
    if isinstance(tree, tuple):
        return ("seq", tuple(_flatten(v, leaves) for v in tree))
    if tree is None:
        return None
    leaves.append(torch.as_tensor(tree))
    return "leaf"


def _unflatten(spec, it):
    if spec is None:
        return None
    if spec == "leaf":
        return next(it)
    if spec[0] == "dict":
        return {k: _unflatten(s, it) for k, s in zip(spec[1], spec[2])}
    return tuple(_unflatten(s, it) for s in spec[1])


def _map(fn, tree):
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([fn(t) for t in leaves]))


def on_device(tree, device):
    """``tree`` with every leaf a tensor on ``device``: the inputs of an
    eager call."""
    return _map(lambda t: t.to(device), tree)


def _seed(generators, seeds) -> None:
    for g, s in zip(generators, seeds):
        g.manual_seed(s)


def _address(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class _Entry:
    """The static buffers, graph and outputs of one key."""

    def __init__(self, leaves, device, n_generators: int = 0):
        self.inputs = [torch.empty(tuple(t.shape), dtype=t.dtype,
                                   device=device) for t in leaves]
        self.generators = [torch.Generator(device=device)
                           for _ in range(n_generators)]
        self.graph = None
        self.outputs = None
        self.tally: dict = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.calls = 0


def captures_on(device, mesh, what: str) -> bool:
    """Whether programs (``what``, for the log) run as CUDA graph replays:
    on the card, over no mesh or over a mesh whose groups are all NCCL
    (``parallel.mesh.mesh_captures``).  A mesh that keeps them eager is
    logged here."""
    on_card = torch.device(device).type == "cuda"
    if mesh is None:
        return on_card
    from ..parallel.mesh import mesh_captures
    if on_card and mesh_captures(mesh):
        return True
    log.info("mesh: %s: eager calls (the mesh's %s collectives are not "
             "captured)", what, "gloo" if on_card else mesh.device_type)
    return False


class GraphedCall:
    """Runs pure no-grad functions of static inputs, one CUDA graph replay
    a call on the card (``captures``), eagerly on the CPU.  ``name``: what
    a failed capture and the log call the graphs.  ``mesh``: the mesh whose
    collectives the functions run: eager over gloo, captured with them
    over NCCL, keys free of rank-local values (module docstring)."""

    def __init__(self, device, *, captures: bool = True, name: str = "call",
                 mesh=None):
        self.device = torch.device(device)
        self.captures = captures and captures_on(self.device, mesh, name)
        self.mesh = mesh if self.captures else None
        self._meshed = mesh is not None
        self.name = name
        self._entries: dict = {}
        self._stream = None
        self._pool = None

    # ---------------------------------------------------------------- keys
    def drop(self) -> None:
        """Drop every key: their graphs, buffers and outputs (over a mesh,
        on every rank at the same point)."""
        self._entries.clear()

    def keys(self) -> list:
        return list(self._entries)

    # ---------------------------------------------------------------- stats
    @property
    def replays(self) -> int:
        """Graph replays so far, over every key kept."""
        return sum(e.replays for e in self._entries.values())

    def stats(self) -> list[dict]:
        """One dict per key kept: the key, capture seconds (instantiation
        included; the self time of its ``graph.capture`` span), the growth
        of the card's reserved memory across the capture (the shared pool's
        share of this key), the tally of kernel launches one replay makes,
        replays and calls."""
        return [{"key": k[0], "capture_s": e.capture_s,
                 "pool_bytes": e.pool_bytes, "tally": dict(e.tally),
                 "replays": e.replays, "calls": e.calls}
                for k, e in self._entries.items()]

    # ----------------------------------------------------------------- call
    def __call__(self, key: tuple, fn: Callable, *args, fixed=(),
                 generators=()):
        """``fn(*args)`` on static copies of ``args`` (dicts and tuples of
        tensors, numpy arrays or lists; None allowed): one replay of the
        graph of this key on the card, an eager call otherwise.  ``key``:
        what ``fn`` closes over that shapes its work; ``fixed``: a tree of
        tensors ``fn`` reads in place (their addresses join the key);
        ``generators``: a seed for each generator ``fn`` draws from
        (passed to it as ``generators=``, a list)."""
        if fixed and self._meshed:
            raise ValueError(f"{self.name}: a meshed call's key holds "
                             f"nothing rank-local, so no fixed= addresses")
        leaves: list = []
        spec = _flatten(args, leaves)
        held: list = []
        _flatten(fixed, held)
        seeds = tuple(int(s) for s in generators)
        full = (key, spec, tuple((tuple(t.shape), t.dtype) for t in leaves),
                tuple(_address(t) for t in held), len(seeds))
        entry = self._entries.get(full)
        if entry is None:
            entry = _Entry(leaves, self.device, len(seeds))
        for buf, t in zip(entry.inputs, leaves):
            buf.copy_(t)
        static = _unflatten(spec, iter(entry.inputs))
        kw = {"generators": entry.generators} if seeds else {}

        def call():
            return fn(*static, **kw)

        if not self.captures:
            _seed(entry.generators, seeds)
            with torch.no_grad():
                out = call()
            # an output that is (a view of) a static input would change
            # under the key's next call: a copy, as a replay's clone is
            ins = {t.untyped_storage().data_ptr() for t in entry.inputs}
            out = _map(lambda t: t.clone() if t.untyped_storage().data_ptr()
                       in ins else t, out)
        else:
            if entry.graph is None:
                self._capture(entry, key, call)
            _seed(entry.generators, seeds)  # after the warm-up's draws
            entry.graph.replay()
            add_tally(sk.LAUNCH_COUNTS, entry.tally)
            entry.replays += 1
            out = _map(torch.clone, entry.outputs)
        entry.calls += 1
        self._entries[full] = entry
        return out

    def _capture(self, entry: _Entry, key, call) -> None:
        """The warm-up call and the capture under one ``graph.capture``
        span; the warm-up, up to the settled card, is its ``graph.warmup``
        span, so the capture's self time, ``capture_s``, is the capture and
        the instantiation alone."""
        with span("graph.capture") as timed:
            dev = self.device
            entry.graph = entry.outputs = None    # a recapture frees the old
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
                self._pool = torch.cuda.graph_pool_handle()
            side, current = self._stream, torch.cuda.current_stream(dev)
            side.wait_stream(current)
            with span("graph.warmup") as warmup:
                _seed(entry.generators, [0] * len(entry.generators))
                with torch.no_grad(), torch.cuda.stream(side):
                    call()                      # outputs discarded
                current.wait_stream(side)
                # no garbage collection inside the capture: a collected
                # cycle that holds another graph destroys it mid-capture, a
                # call the capture refuses, which invalidates it
                gc.collect()
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            for g in entry.generators:
                graph.register_generator_state(g)
            held = []

            def capture():
                # thread-local: a server's other threads may use the card
                with torch.no_grad(), torch.cuda.graph(
                        graph, pool=self._pool, stream=side,
                        capture_error_mode="thread_local"):
                    held.append(call())

            collecting = gc.isenabled()
            gc.disable()
            try:
                entry.tally = record_tally(sk.LAUNCH_COUNTS, capture)
            except RuntimeError as exc:
                self._pool = torch.cuda.graph_pool_handle()
                raise RuntimeError(
                    f"capturing {self.name} {key} as a CUDA graph failed at "
                    f"{_origin(exc)}") from exc
            finally:
                if collecting:
                    gc.enable()
                # a capture_end that raises leaves the capture stream current
                torch.cuda.set_stream(current)
            entry.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        entry.graph, entry.outputs = graph, held[0]
        entry.capture_s = timed.self_ns / 1e9
        log.info("captured %s %s in %.3f s after a %.3f s warm-up (graph "
                 "pool +%.1f MiB; kernel launches a replay %s)", self.name,
                 key, entry.capture_s, warmup.seconds,
                 entry.pool_bytes / 2**20, entry.tally)
