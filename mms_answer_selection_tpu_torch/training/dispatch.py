"""Chunks of training steps as one dispatch (counterpart of the JAX
trainer's ``_scan_steps_jit`` / ``_run_chunk`` and of the JAX
``GraphSolver``'s jitted step).

The JAX package runs a chunk of K steps as one compiled ``lax.scan``.
Here a chunk of K steps is one replay of a CUDA graph captured around K
calls of the owner's own step code (``Trainer._train_step``,
``GraphSolver._graph_step``), so the card runs the chunk's ~500 launches
a step with no Python between them.

``StepRunner`` knows no trainer: it takes the step callable, ``iter_size``,
the seed of each micro-batch's generator, the device and whether to
capture.  ``ChunkRunner`` is the ``Trainer``'s runner built through that
interface.

The graph works on static buffers, which every replay reads and writes in
place:

* the carry (params, BN state, solver history), one set a runner, shared
  by the graphs of every chunk length: each step writes its results into
  it with ``copy_``;
* per chunk length, the K batches (each field (K, [iter_size,] B, ...)),
  the first step as a 0-d int64 tensor (step ``step0 + i`` is computed on
  the device, so the learning rate and Adam's correction make no host
  round trip), the K losses and the last step's other outputs (for
  ``GraphSolver``, the train net's output blobs);
* per chunk length, K x iter_size dropout generators registered with the
  graph and re-seeded on the host before each replay with the seeds the
  eager step draws from, so a replay draws the eager step's masks.

A chunk length is captured the first time it runs: one step of the body
on a side stream first (outputs discarded; it loads the kernels' library,
makes the first launches' attribute calls and lets cuBLAS and cuDNN set
up), then ``torch.cuda.graph`` around the K steps.  A capture that fails
(a host sync inside the step, a copy from the host) raises, naming the
line that failed; nothing falls back to eager steps.

The pair-map kernels' wrappers count their launches in Python, which a
replay never runs: a capture's increments are taken back (nothing ran),
kept as the graph's tally, and added once per replay.

On the CPU, and on the card over a gloo mesh (a gloo collective waits
on the host), the same body runs as eager steps on the same static
buffers.  Over an NCCL mesh (``mesh=``) the step's collectives are
captured with it.  Every rank must capture a chunk length at the same
run, and does: a chunk's key (K, iter_size and the global batch's shapes)
holds nothing rank-local.
Captures run in ``thread_local`` mode, so the NCCL watchdog thread's
event queries during a capture do not invalidate it.
"""

from __future__ import annotations

import gc
import logging
import weakref
from typing import Callable

import torch

from ..ops import sim_cross_kernels as sk
from ..utils.graphs import _origin, add_tally, captures_on, record_tally
from ..utils.timer import span
from ..utils.tree import tree_map

log = logging.getLogger("mms_tpu_torch.dispatch")


def _copy_tree(dst, src) -> None:
    """Each leaf of ``src`` into the leaf of ``dst`` under the same keys."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"carry keys {sorted(src)} != {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif dst is not src:
        dst.copy_(src)


def _same_leaves(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_leaves(a[k], b[k]) for k in a)
    return isinstance(b, torch.Tensor) and a.shape == b.shape \
        and a.dtype == b.dtype and a.device == b.device


def _named(carry) -> dict:
    params, state, opt_state = carry
    return {"params": params, "state": state, "opt_state": opt_state}


def _is_view(static, tree) -> bool:
    """Whether every leaf of ``tree`` is the leaf of ``static`` under the
    same keys (nothing to load)."""
    if isinstance(static, dict):
        return isinstance(tree, dict) and static.keys() == tree.keys() \
            and all(_is_view(static[k], tree[k]) for k in static)
    return static is tree


def _view(tree):
    """New dicts over the leaves of ``tree``: entries rebound in them
    leave ``tree`` as it is."""
    if isinstance(tree, dict):
        return {k: _view(v) for k, v in tree.items()}
    return tree


class _Chunk:
    """The static buffers, generators, outputs and graph of one chunk
    length."""

    def __init__(self, batches: dict, k: int, iter_size: int,
                 device: torch.device):
        self.k = k
        self.batches = {n: torch.empty((k,) + tuple(v.shape), dtype=v.dtype,
                                       device=device)
                        for n, v in batches.items()}
        self.step0 = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = torch.zeros((k,), dtype=torch.float32, device=device)
        self.outputs = None
        self.generators = [[torch.Generator(device=device)
                            for _ in range(iter_size)] for _ in range(k)]
        self.graph = None
        self.tally: dict = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0


class StepRunner:
    """Runs chunks of steps on a static carry, one CUDA graph replay a
    chunk where ``captures`` (the card, over no mesh or an NCCL ``mesh``:
    ``utils/graphs.captures_on``), eager steps otherwise.  ``mesh``: the mesh whose collectives ``step``
    runs.

    ``step(params, state, opt_state, batch, step, generators=)`` returns
    (params, state, opt_state, loss[, outputs]): ``step`` is a 0-d int64
    tensor on the device, ``generators`` the iter_size generators of its
    micro-batches, ``outputs`` a tree of tensors the chunk's last step
    leaves in ``outputs``.  ``seed(step, j)``: the seed of micro-batch
    ``j``'s generator at ``step`` (an int).

    ``carry``: (params, state, opt_state), copied into the runner's own
    buffers (``load`` copies a later carry in); ``carry`` afterwards is the
    static carry itself, which the next chunk overwrites: clone what must
    outlive it (``snapshot``).

    ``keep_graphs``: keep each captured graph's node list, so that
    ``utils.graphs.kernel_nodes(runner.graph(k), ...)`` can read the
    kernel nodes of the k-step graph."""

    def __init__(self, step: Callable, carry, *, iter_size: int,
                 seed: Callable[[int, int], int], device, captures: bool,
                 name: str = "chunk", mesh=None):
        self.step = step
        self.iter_size = iter_size
        self.seed = seed
        self.device = torch.device(device)
        self.name = name
        self._carry = tree_map(torch.clone, _named(carry))
        self.captures = captures and captures_on(self.device, mesh, name)
        self.mesh = mesh if self.captures else None
        self._chunks: dict = {}
        self._stream = None
        self.outputs = None
        self.keep_graphs = False

    # ---------------------------------------------------------------- carry
    @property
    def carry(self) -> tuple:
        """The static (params, state, opt_state)."""
        c = self._carry
        return c["params"], c["state"], c["opt_state"]

    def fits(self, carry) -> bool:
        """Whether ``carry`` has the static carry's keys and leaves
        (shapes, dtypes, device), so it can be loaded into it."""
        return _same_leaves(self._carry, _named(carry))

    def load(self, carry) -> None:
        _copy_tree(self._carry, _named(carry))

    def adopt(self, carry) -> bool:
        """Load ``carry`` unless its leaves are the static carry's own;
        False (nothing loaded) when it does not fit."""
        named = _named(carry)
        if _is_view(self._carry, named):
            return True
        if not self.fits(carry):
            return False
        self.load(carry)
        return True

    def view(self) -> tuple:
        """(params, state, opt_state): new dicts over the static leaves,
        for an owner to hand out (a user who rebinds an entry in them
        leaves the static carry as it is, and ``adopt`` copies it in)."""
        c = _view(self._carry)
        return c["params"], c["state"], c["opt_state"]

    def snapshot(self) -> tuple:
        """Clones of the carry, which no later chunk overwrites."""
        c = tree_map(torch.clone, self._carry)
        return c["params"], c["state"], c["opt_state"]

    # ---------------------------------------------------------------- stats
    @property
    def replays(self) -> int:
        """Graph replays so far, one per chunk run on the card."""
        return sum(c.replays for c in self._chunks.values())

    def stats(self) -> list[dict]:
        """One dict per chunk length run so far: its K, capture seconds
        (instantiation included; the self time of its ``graph.capture``
        span), graph-pool bytes, the tally of kernel launches one replay
        makes, and its replays."""
        return [{"k": c.k, "capture_s": c.capture_s,
                 "pool_bytes": c.pool_bytes, "tally": dict(c.tally),
                 "replays": c.replays}
                for c in self._chunks.values()]

    def graph(self, k: int) -> torch.cuda.CUDAGraph:
        """The captured graph of the chunk length ``k``."""
        (graph,) = [c.graph for c in self._chunks.values()
                    if c.k == k and c.graph is not None]
        return graph

    # ----------------------------------------------------------------- run
    def run(self, batches, step0, *, generators=None) -> torch.Tensor:
        """Steps ``step0`` .. ``step0 + K - 1`` on ``batches``: a list of K
        batch dicts (an empty dict each where the step takes no input), or
        one dict of (K, ...) stacked tensors, on the device or the host.
        ``step0``: an int, or a 0-d integer tensor.  Returns the static
        (K,) losses, which the next chunk of this length overwrites; the
        last step's other outputs are in ``outputs``, as static.

        ``generators``: K lists of iter_size generators of the caller's to
        draw from in place of ``seed``'s: each step's own generators take
        their states first, and give them back advanced after the run, as
        if the steps had drawn from the caller's."""
        with span("chunk.stage"):
            if isinstance(batches, dict):
                k = next(iter(batches.values())).shape[0]
                first = {n: v[0] for n, v in batches.items()}
            else:
                k, first = len(batches), batches[0]
            iter_size = self.iter_size
            key = (k, iter_size) + tuple(
                (n, tuple(v.shape), v.dtype) for n, v in sorted(first.items()))
            chunk = self._chunks.get(key)
            if chunk is None:
                chunk = _Chunk(first, k, iter_size, self.device)
            for n, buf in chunk.batches.items():
                if isinstance(batches, dict):
                    buf.copy_(batches[n])
                elif batches[0][n].device == buf.device:
                    torch.stack([b[n] for b in batches], out=buf)
                else:               # host batches: one copy to the device
                    buf.copy_(torch.stack([b[n] for b in batches]))
            chunk.step0.fill_(step0)
        if self.captures and chunk.graph is None:
            self._capture(chunk)
        with span("chunk.replay"):
            self._seed(chunk, step0, generators)  # after the warm-up's draws
            if self.captures:
                chunk.graph.replay()
                add_tally(sk.LAUNCH_COUNTS, chunk.tally)
                chunk.replays += 1
            else:
                self._body(chunk)
        if generators is not None:
            for mine, theirs in zip(chunk.generators, generators):
                for g, t in zip(mine, theirs):
                    t.set_state(g.get_state())
        self._chunks[key] = chunk
        self.outputs = chunk.outputs
        return chunk.losses

    def _seed(self, chunk: _Chunk, step0, generators=None) -> None:
        """Each generator re-seeded as the eager step seeds its own, or
        given the state of the caller's generator in its place."""
        for i, row in enumerate(chunk.generators):
            for j, g in enumerate(row):
                if generators is not None:
                    g.set_state(generators[i][j].get_state())
                else:
                    g.manual_seed(self.seed(step0 + i, j))

    def _step(self, chunk: _Chunk, i: int):
        return self.step(
            *self.carry, {n: v[i] for n, v in chunk.batches.items()},
            chunk.step0 + i, generators=chunk.generators[i])

    def _body(self, chunk: _Chunk) -> None:
        """The K steps, each writing its carry and loss in place; the last
        step's outputs kept (static under a capture)."""
        for i in range(chunk.k):
            params, state, opt_state, loss, *outputs = self._step(chunk, i)
            _copy_tree(self._carry, _named((params, state, opt_state)))
            chunk.losses[i].copy_(loss)
            chunk.outputs = outputs[0] if outputs else None

    def _capture(self, chunk: _Chunk) -> None:
        """The warm-up step and the capture under one ``graph.capture``
        span; the warm-up, up to the settled card, is its ``graph.warmup``
        span, so the capture's self time, ``capture_s``, is the capture and
        the instantiation alone."""
        with span("graph.capture") as timed:
            chunk.graph = None                   # a recapture frees the old
            dev = self.device
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            side, current = self._stream, torch.cuda.current_stream(dev)
            side.wait_stream(current)
            with span("graph.warmup") as warmup:
                self._seed(chunk, 0)
                with torch.cuda.stream(side):   # outputs discarded
                    self._step(chunk, 0)
                torch.cuda.current_stream(dev).wait_stream(side)
                # no garbage collection inside the capture: a collected
                # cycle that holds another graph destroys it mid-capture, a
                # call the capture refuses, which invalidates it
                gc.collect()
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            # a kept node list is instantiated below, inside the span
            graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
            for row in chunk.generators:
                for g in row:
                    graph.register_generator_state(g)

            def capture():
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self._body(chunk)
                if self.keep_graphs:
                    graph.instantiate()

            collecting = gc.isenabled()
            gc.disable()
            try:
                chunk.tally = record_tally(sk.LAUNCH_COUNTS, capture)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"capturing a {chunk.k}-step {self.name} as a CUDA graph "
                    f"failed at {_origin(exc)}") from exc
            finally:
                if collecting:
                    gc.enable()
                # a capture_end that raises leaves the capture stream current
                torch.cuda.set_stream(current)
            chunk.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        chunk.graph = graph
        chunk.capture_s = timed.self_ns / 1e9
        log.info("captured a %d-step %s in %.3f s after a %.3f s warm-up "
                 "(graph pool %.1f MiB; kernel launches a replay %s)",
                 chunk.k, self.name, chunk.capture_s, warmup.seconds,
                 chunk.pool_bytes / 2**20, chunk.tally)


class ChunkRunner(StepRunner):
    """The ``Trainer``'s runner: its ``_train_step``, iter_size and dropout
    seeds (``_dropout_seed(step)``, or ``(step, j)`` over micro-batches),
    capturing where the trainer does (``Trainer.captures``)."""

    def __init__(self, trainer, carry):
        # weak: the trainer keeps its runner, and a cycle would hold the
        # graphs' pools until the garbage collector found it
        owner = weakref.proxy(trainer)
        iter_size = trainer.cfg.solver.iter_size

        def step(*args, **kw):
            return owner._train_step(*args, **kw)

        def seed(it: int, j: int) -> int:
            return owner._dropout_seed(it) if iter_size == 1 \
                else owner._dropout_seed(it, j)

        super().__init__(step, carry, iter_size=iter_size, seed=seed,
                         device=trainer.device,
                         captures=trainer.captures, mesh=trainer.mesh)
