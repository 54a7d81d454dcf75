"""GraphSolver: the generic ``caffe train --solver=...`` loop (counterpart
of ``training/graph_solver.py``).

Write a ``solver.prototxt`` that names a NetParameter prototxt, run it,
and the solver drives the rest: the train and test nets
(solver.cpp:87-185), the step loop with the smoothed-loss display
(solver.cpp:193-290, 482-495), test passes averaging every output blob
over ``test_iter`` batches (solver.cpp:334-404), snapshots of the learned
weights and the solver history in the reference's files
(solver.cpp:406-457) and restore (solver.cpp:470-481).

* The net is a ``GraphNet``; a step is forward, autograd backward and
  the solver update.  With ``iter_size`` > 1 the gradients of the
  micro-batches are summed (the solver divides by ``iter_size``), the BN
  statistics threaded through them in order.
* On the card (over no mesh or an NCCL one) each iteration is one
  replay of a CUDA graph
  captured around one step (``training/dispatch.StepRunner``), as the JAX
  package's is one ``jax.jit`` call: the iteration's micro-batches are
  pulled on the host and copied into static (iter_size, B, ...) buffers,
  the iteration is a 0-d int64 tensor on the device, the params, BN state
  and solver history a static carry the replay updates in place.  Around
  the replay everything stays on the host, in the reference's order.
  ``params``, ``state`` and ``opt_state`` are then views of the static
  carry: a later step overwrites them (clone what must outlive it), and
  trees rebound in their place (``restore``, ``copy_weights``, an
  assignment) are copied into it before the next step or test pass.
  Each test batch is one replay too (``utils/graphs.GraphedCall``),
  reading the static carry in place.  ``_train_step`` and
  ``_test_outputs_eager`` are the plain versions, run eagerly.
* Spans (``utils/timer.py``): each iteration is a ``solver.step`` holding
  ``solver.pull`` (the host batch), the runner's ``chunk.stage`` and
  ``chunk.replay`` and ``solver.read`` (the loss and the outputs read
  back); ``solver.display``, ``solver.test`` and ``solver.snapshot``
  where those run.  The ``Data`` feed opens ``feed.read`` and
  ``feed.transform`` once a batch (``data/lmdb_data.py``), on the feed's
  worker thread (``_Feed``), which a profiler started by the caller does
  not see: they join their aggregates.
* Data layers declare inputs; the host-side feed of each is built from its
  prototxt message: ``feeds=`` arrays, HDF5Data through
  ``data/hdf5_compat.py`` (h5py), ImageData / PairImageData through
  ``data/pair_image.py``, Data (LMDB / LevelDB) through
  ``data/lmdb_data.py``, WindowData through ``data/window_data.py``;
  DummyData fills in the graph.
* Test nets share trained layers by layer name (a dict merge); their
  test-only layers keep their own params.
* ``restore`` fast-forwards every feed by the batches the snapshotted run
  consumed, so a resumed run repeats the uninterrupted one; dropout and
  the other random layers draw from a generator seeded by (seed, iter).

* User ``Python`` layers run inside the capture: they must make no host
  sync (``.item()``, ``float(tensor)``, a copy to the host).  A layer that
  does fails the capture, which raises naming its line; nothing falls
  back to eager steps.

* ``mesh=``: data parallelism over a ``parallel.make_mesh`` mesh.  Every
  rank pulls the same global batches and takes its rows (each micro-batch
  split on its sample axis); BN / BatchNorm take the global batch's
  statistics, Dropout draws its masks, and the gradients and the loss are
  all-reduced to the global-batch mean.  The loss layers normalize over
  each rank's rows, so a layer whose count varies by rank (an
  ``ignore_label``) weighs the ranks' means equally.  Rank 0 writes the
  snapshots.  On an NCCL mesh its steps and test passes are graph
  replays: a step's collectives are captured with it, every rank capturing
  at the same call, and a test pass runs none.  On a gloo mesh they run
  eagerly on the same static buffers, as on the CPU
  (``utils/graphs.captures_on``).
"""

from __future__ import annotations

import logging
import os
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..models.graph_net import DATA_TYPES, GraphNet
from ..utils.prototxt import parse_prototxt, solver_config_from_prototxt
from ..utils.graphs import GraphedCall, captures_on, on_device
from ..utils.seed import derive_seed
from ..utils.timer import span
from ..utils.tree import tree_leaves, tree_map
from ..parallel.mesh import mesh_device, shard_context
from ..parallel.train_step import local_batch, reduce_grads
from .dispatch import StepRunner
from .optim import learning_rate, make_solver

log = logging.getLogger("mms_tpu_torch.graph_solver")

# seed-derivation tags of the init, step and test generators
_INIT, _STEP, _TEST = 0xD0, 0x5EED, 0x7E57


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _one(v, default=None):
    if isinstance(v, list):
        return v[-1] if v else default
    return default if v is None else v


def _pbool(v, default=False):
    """Protobuf text bools: ``true`` / ``false`` and ``0`` / ``1``."""
    v = _one(v, default)
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1")
    return bool(v)


def _read(path_or_text: str) -> str:
    """A path, or raw prototxt text (text holds a newline or a brace)."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            return f.read()
    if "{" in path_or_text or "\n" in path_or_text:
        return path_or_text
    raise FileNotFoundError(path_or_text)


def _resolve(path: str, base_dir: str) -> str:
    if not os.path.isabs(path):
        cand = os.path.join(base_dir, path)
        return cand if os.path.exists(cand) else path
    return path


class _Feed:
    """Host-side batch source for one data layer: each ``next()`` yields
    {top: array} for the layer's tops.

    As the reference's data layers prefetch on a thread of their own
    (base_data_layer.cpp, ``BasePrefetchingDataLayer``), the batch after
    the one handed out is read on a worker thread while the caller steps:
    the same batches in the same order, one read ahead.  The worker exits
    once the feed is dropped."""

    def __init__(self, it, tops):
        self.it = it
        self.tops = tops
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="feed")
        self._ahead = None

    def _read(self):
        batch = next(self.it)
        return {t: batch[t] for t in self.tops}

    def __next__(self):
        ahead = self._ahead or self._worker.submit(self._read)
        batch = ahead.result()
        self._ahead = self._worker.submit(self._read)
        return batch

    def skip(self, n: int):
        for _ in range(n):
            next(self)


def _mean_from(tf: dict, t: str, name: str, base_dir: str):
    """The transform's mean: ``mean_value`` entries or a ``mean_file``
    BlobProto (data_transformer.cpp:25-48 refuses both)."""
    mv = _as_list(tf.get("mean_value"))
    mf = _one(tf.get("mean_file"))
    if mv and mf:
        raise ValueError(f"{t} layer {name!r}: transform_param sets both "
                         f"mean_file and mean_value")
    if mv:
        return np.asarray(mv, np.float32)
    if mf:
        from ..data.pair_image import load_mean_hwc

        return load_mean_hwc(_resolve(str(mf), base_dir))
    return None


def _build_feed(node_cfg: dict, phase: str, seed: int, base_dir: str,
                feeds: dict | None):
    """One data layer -> _Feed, or None (DummyData fills in the graph).

    ``feeds={layer_name: {top: array, ..., "batch_size": n[, "shuffle":
    bool]}}`` feeds any data layer.  Otherwise HDF5Data maps each top to
    the equally named dataset across the source list's chunk files
    (hdf5_data_layer.cpp:30-83), ImageData / PairImageData read their image
    lists, Data reads an LMDB or LevelDB of Datums (``data/lmdb_data.py``)
    and WindowData an R-CNN window file (``data/window_data.py``)."""
    from ..data.loader import ArrayDataset, BatchIterator

    t = str(node_cfg.get("type", ""))
    name = str(node_cfg.get("name", ""))
    tops = [str(s) for s in _as_list(node_cfg.get("top"))]
    if t == "DummyData":
        return None
    if feeds and name in feeds:
        spec = dict(feeds[name])
        bs = int(spec.pop("batch_size", 0))
        shuffle = bool(spec.pop("shuffle", phase == "train"))
        ds = ArrayDataset(spec)
        return _Feed(BatchIterator(ds, bs or len(ds), seed=seed,
                                   shuffle=shuffle), tops)
    if t == "HDF5Data":
        from ..data.hdf5_compat import load_hdf5_list

        p = _one(node_cfg.get("hdf5_data_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"HDF5Data layer {name!r} has no source")
        source = _resolve(str(source), base_dir)
        arrays = load_hdf5_list(source)
        missing = [top for top in tops if top not in arrays]
        if missing:
            raise KeyError(f"HDF5Data {name!r}: datasets {missing} not in "
                           f"{source} (tops read equally-named datasets)")
        ds = ArrayDataset({top: arrays[top] for top in tops})
        return _Feed(BatchIterator(ds, int(_one(p.get("batch_size"), 1)),
                                   seed=seed,
                                   shuffle=_pbool(p.get("shuffle"))), tops)
    if t in ("ImageData", "PairImageData"):
        from ..data.pair_image import ImageListDataset, PairImageDataset

        pkey = ("image_data_param" if t == "ImageData"
                else "pair_image_data_param")
        p = _one(node_cfg.get(pkey), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"{t} layer {name!r} has no source")
        source = _resolve(str(source), base_dir)
        root = str(_one(p.get("root_folder"), "")) or os.path.dirname(source)
        kw = dict(
            root=root, seed=seed,
            shuffle=_pbool(p.get("shuffle")),
            rand_skip=int(_one(p.get("rand_skip"), 0)),
            new_height=int(_one(p.get("new_height"), 0)),
            new_width=int(_one(p.get("new_width"), 0)),
            # TransformationParameter wins over the layer's deprecated
            # copies (data_transformer.cpp owns these knobs)
            scale=float(_one(tf.get("scale"), _one(p.get("scale"), 1.0))),
            mean=_mean_from(tf, t, name, base_dir),
            crop_size=int(_one(tf.get("crop_size"),
                               _one(p.get("crop_size"), 0))),
            mirror=_pbool(tf.get("mirror"), _pbool(p.get("mirror"))),
            train=phase == "train")
        bs = int(_one(p.get("batch_size"), 1))
        if t == "ImageData":
            kw["is_color"] = _pbool(p.get("is_color"), True)
            ds = ImageListDataset(source, bs, **kw)

            def gen(ds=ds, tops=tops):
                for b in ds:
                    yield {tops[0]: b["data"], tops[1]: b["label"]}
        else:
            ds = PairImageDataset(source, bs, **kw)

            def gen(ds=ds, tops=tops):
                for b in ds:
                    # the layer stacks the pair on the channel axis
                    # (pair_image_data_layer.cpp:26-178); NHWC here
                    yield {tops[0]: np.concatenate([b["img1"], b["img2"]],
                                                   axis=-1),
                           tops[1]: b["label"]}
        return _Feed(gen(), tops)
    if t == "WindowData":
        from ..data.window_data import WindowListDataset

        p = _one(node_cfg.get("window_data_param"), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"WindowData layer {name!r} has no source")
        ds = WindowListDataset(
            _resolve(str(source), base_dir),
            int(_one(p.get("batch_size"), 1)),
            crop_size=int(_one(tf.get("crop_size"), 0)),
            root=str(_one(p.get("root_folder"), "")),
            fg_threshold=float(_one(p.get("fg_threshold"), 0.5)),
            bg_threshold=float(_one(p.get("bg_threshold"), 0.5)),
            fg_fraction=float(_one(p.get("fg_fraction"), 0.25)),
            context_pad=int(_one(p.get("context_pad"), 0)),
            crop_mode=str(_one(p.get("crop_mode"), "warp")),
            mirror=_pbool(tf.get("mirror")),
            mean=_mean_from(tf, t, name, base_dir),
            scale=float(_one(p.get("scale"), 1.0)),
            cache_images=_pbool(p.get("cache_images")),
            seed=seed)

        def gen(ds=ds, tops=tops):
            for b in ds:
                yield {tops[0]: b["data"], tops[1]: b["label"]}
        return _Feed(gen(), tops)
    if t == "Data":
        from ..data.lmdb_data import open_datum_dataset

        p = _one(node_cfg.get("data_param"), {}) or {}
        tf = _one(node_cfg.get("transform_param"), {}) or {}
        source = _one(p.get("source"))
        if source is None:
            raise ValueError(f"Data layer {name!r} has no source")
        source = _resolve(str(source), base_dir)
        # the backend is read from the directory (data.mdb vs CURRENT),
        # as db.cpp:41 GetDB would pick it; `backend:` is not consulted
        has_mdb = os.path.exists(
            source if source.endswith(".mdb")
            else os.path.join(source, "data.mdb"))
        has_current = os.path.exists(os.path.join(source, "CURRENT"))
        if not has_mdb and not has_current:
            raise ValueError(
                f"Data layer {name!r}: {source!r} is neither an LMDB "
                f"environment (data.mdb) nor a LevelDB directory "
                f"(CURRENT)")
        # the deprecated data_param mean_file still counts
        # (data_transformer.cpp reads transform_param's first)
        if "mean_file" not in tf and _one(p.get("mean_file")) is not None:
            tf = {**tf, "mean_file": p.get("mean_file")}
        ds = open_datum_dataset(
            source, int(_one(p.get("batch_size"), 1)),
            scale=float(_one(tf.get("scale"), _one(p.get("scale"), 1.0))),
            mean=_mean_from(tf, t, name, base_dir),
            crop_size=int(_one(tf.get("crop_size"),
                               _one(p.get("crop_size"), 0))),
            mirror=_pbool(tf.get("mirror"), _pbool(p.get("mirror"))),
            rand_skip=int(_one(p.get("rand_skip"), 0)),
            train=phase == "train", seed=seed)

        def gen(ds=ds, tops=tops):
            for b in ds:
                yield {tops[0]: b["data"], tops[1]: b["label"]}
        return _Feed(gen(), tops)
    raise ValueError(
        f"data layer {name!r} (type {t}) needs a feeds= entry: "
        f"feeds={{{name!r}: {{top: array, ..., 'batch_size': n}}}} — only "
        f"Data (LMDB / LevelDB), HDF5Data, ImageData, PairImageData, "
        f"WindowData and DummyData sources are read from the prototxt")


class GraphSolver:
    """Drive any prototxt net through the reference solver loop on one
    device (``None`` means CUDA, and raises without it).

    >>> gs = GraphSolver("solver.prototxt", device="cuda")
    >>> gs.solve()                       # caffe train --solver=...
    >>> gs.test()                        # one TestAll pass
    >>> gs.restore("x.solverstate")      # caffe train --snapshot=...
    >>> gs.copy_weights("w.caffemodel")  # caffe train --weights=...
    """

    def __init__(self, solver: str, *, base_dir: str | None = None,
                 feeds: dict | None = None, seed: int = 0,
                 on_display=None, device=None, mesh=None):
        self.mesh = mesh
        self._shards = shard_context(mesh).without_tp()  # tp: replicas
        if mesh is not None and device is None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        text = _read(solver)
        self.base_dir = base_dir or (
            os.path.dirname(os.path.abspath(solver))
            if os.path.exists(solver) else ".")
        d = parse_prototxt(text)
        self.cfg, self.extras = solver_config_from_prototxt(text)
        self.raw = d
        self.test_interval = int(_one(d.get("test_interval"), 0))
        self.test_iters = [int(v) for v in _as_list(d.get("test_iter"))]
        self.test_initialization = _pbool(d.get("test_initialization"),
                                          True)
        self.average_loss = int(_one(d.get("average_loss"), 1))
        self.display = int(_one(d.get("display"), 0))
        self.snapshot_every = int(_one(d.get("snapshot"), 0))
        self.snapshot_prefix = _one(d.get("snapshot_prefix"), "graph")
        fmt = str(_one(d.get("snapshot_format"), "BINARYPROTO")).upper()
        self.snapshot_h5 = fmt == "HDF5"
        self.snapshot_after_train = _pbool(d.get("snapshot_after_train"),
                                           True)
        self.max_iter = int(_one(d.get("max_iter"), 0))
        rs = _one(d.get("random_seed"))
        self.seed = int(rs) if rs is not None else seed
        self.on_display = on_display

        # -- nets (solver.cpp:87-185 field precedence) --------------------
        train_src, test_srcs = self._net_sources(d)
        self.net = GraphNet(train_src, phase="train")
        self.test_nets = [GraphNet(s, phase="test") for s in test_srcs]
        if self.test_nets and len(self.test_iters) < len(self.test_nets):
            raise ValueError(
                f"{len(self.test_nets)} test nets need test_iter each "
                f"(solver.cpp:106-109); got {self.test_iters}")

        # -- feeds and init -------------------------------------------------
        self._user_feeds = feeds  # kept: restore() rebuilds from 0
        self._reset_feeds()
        gen = torch.Generator().manual_seed(derive_seed(self.seed, _INIT))
        self.params, self.state = self.net.init(
            gen, self._next_batch(self._feeds), device=self.device)
        self.solver = make_solver(self.cfg, self.net.param_spec(self.params))
        self.opt_state = self.solver.init(self.params)
        self._test_shadow = []  # params/state of test-only layers
        for i, tnet in enumerate(self.test_nets):
            gen = torch.Generator().manual_seed(
                derive_seed(self.seed, _INIT, 100 + i))
            self._test_shadow.append(tnet.init(
                gen, self._next_batch(self._test_feeds[i]),
                device=self.device))
        # init consumed batches for shape inference; the reference's setup
        # only peeks at the prefetch queue, so iteration 0 trains on batch 0
        self._reset_feeds()
        # the step's runner (static carry, one graph a step shape; made at
        # the first step or test pass) and the graphs of the test passes
        # and pycaffe forwards; eager over a gloo mesh and on the CPU
        self.runner: StepRunner | None = None
        self._runner_for = None
        self.captures = captures_on(self.device, mesh, "solver")
        # the forwards run no collective: no mesh, keyed on addresses
        self.forwards = GraphedCall(self.device, captures=self.captures,
                                    name="solver forward")
        self.iter_ = 0
        self._losses: list[float] = []
        self._smoothed = 0.0
        self._start_iter = 0
        self.history: list[dict] = []
        self.last_outs: dict = {}  # train-net output blobs of the last step
        # Solver::Callback pairs (solver.hpp:78-89): (on_start,
        # on_gradients_ready), fired around each step; the update is part
        # of the step, so "gradients ready" and "applied" coincide
        self.callbacks: list = []
        self._early_exit = False

    # ------------------------------------------------------------------
    def _net_sources(self, d):
        def load_net(v):
            if isinstance(v, dict):
                return v
            path = str(v)
            if not os.path.isabs(path):
                path = os.path.join(self.base_dir, path)
            with open(path) as f:
                return f.read()

        train = None
        for field in ("train_net_param", "train_net", "net_param", "net"):
            if field in d:
                train = load_net(_one(d.get(field)))
                break
        if train is None:
            raise ValueError("solver prototxt names no net "
                             "(net/train_net/net_param/train_net_param)")
        tests = [load_net(v) for v in _as_list(d.get("test_net_param"))]
        tests += [load_net(v) for v in _as_list(d.get("test_net"))]
        if not tests and ("net" in d or "net_param" in d) \
                and (self.test_interval or self.test_iters):
            # the generic net serves as its own test net, phase-filtered
            # (solver.cpp:140-151)
            tests.append(load_net(_one(d.get("net_param", d.get("net")))))
        return train, tests

    def _phase_feeds(self, net, phase, *, salt=0):
        out = []
        for node in net.layers:
            if node.type in DATA_TYPES:
                f = _build_feed(node.cfg, phase, self.seed + salt,
                                self.base_dir, self._user_feeds)
                if f is not None:
                    out.append(f)
        return out

    def _reset_feeds(self):
        self._feeds = self._phase_feeds(self.net, "train")
        self._test_feeds = [self._phase_feeds(n, "test", salt=i + 1)
                            for i, n in enumerate(self.test_nets)]

    def _host_batch(self, feed_list):
        """Merge every data layer's next batch into one dict of host
        tensors."""
        batch = {}
        for f in feed_list:
            batch.update(next(f))
        return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}

    def _next_batch(self, feed_list):
        """``_host_batch`` on the device."""
        return on_device(self._host_batch(feed_list), self.device)

    # ------------------------------------------------------------------
    def _loss_and_grads(self, params, state, batch, generator):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), params)
        shards = self._shards if self._shards.dp_size > 1 else None
        loss, (blobs, state) = self.net.loss(
            params, state, local_batch(batch, self._shards),
            generator=generator, shards=shards)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(x)
                 for g, x in zip(grads, leaves)]
        grads, loss = reduce_grads(grads, loss.detach(), self._shards)
        it = iter(grads)
        outs = {t: blobs[t].detach()
                for t in self.net.output_blob_names()}
        return loss, tree_map(lambda _: next(it), params), state, outs

    def _step_body(self, params, state, opt_state, batches, it, generators):
        """One solver iteration on ``batches`` (a batch dict per
        micro-batch, each drawing from its generator): forward, backward
        summed over the micro-batches, update at iteration ``it`` (an int
        or a 0-d integer tensor on the device).  Returns (params, state,
        opt_state, mean loss (0-d tensor), the last micro-batch's output
        blobs)."""
        total, grads = None, None
        for batch, gen in zip(batches, generators):
            loss, g, state, outs = self._loss_and_grads(params, state,
                                                        batch, gen)
            total = loss if total is None else total + loss
            grads = g if grads is None else tree_map(torch.add, grads, g)
        params, opt_state = self.solver.apply(params, grads, opt_state, it)
        return params, state, opt_state, total / len(batches), outs

    def _step_seed(self, it: int, i: int) -> int:
        """The seed of micro-batch ``i``'s generator at iteration ``it``."""
        return derive_seed(self.seed, _STEP, it, i)

    def _train_step(self):
        """One solver iteration on the next batch(es), eagerly (the plain
        version of a step's replay): forward, backward (summed over
        ``iter_size`` micro-batches), update.  Returns the mean loss (0-d
        tensor) and the last micro-batch's output blobs."""
        iter_size = self.cfg.iter_size
        batches = [self._next_batch(self._feeds) for _ in range(iter_size)]
        gens = [torch.Generator(device=self.device).manual_seed(
            self._step_seed(self.iter_, i)) for i in range(iter_size)]
        (self.params, self.state, self.opt_state, loss,
         outs) = self._step_body(self.params, self.state, self.opt_state,
                                 batches, self.iter_, gens)
        return loss, outs

    def _graph_step(self, params, state, opt_state, batch, it, generators):
        """The runner's step: ``batch`` holds the iteration's micro-batches
        stacked on a leading axis when iter_size > 1."""
        micro = [batch] if self.cfg.iter_size == 1 else [
            {k: v[i] for k, v in batch.items()}
            for i in range(self.cfg.iter_size)]
        return self._step_body(params, state, opt_state, micro, it,
                               generators)

    def _pull_train_batch(self) -> dict:
        """The iteration's micro-batches on the host, stacked on a leading
        axis when iter_size > 1."""
        micro = [self._host_batch(self._feeds)
                 for _ in range(self.cfg.iter_size)]
        if len(micro) == 1:
            return micro[0]
        return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}

    def _static_carry(self) -> StepRunner:
        """The step's runner with ``params``, ``state`` and ``opt_state``
        loaded into its static carry (copied in where a tree was rebound
        since), and those three rebound to views of it.  A carry that no
        longer fits, or a new solver or iter_size, makes a new runner and
        drops the forwards' graphs (they read the old carry)."""
        carry = (self.params, self.state, self.opt_state)
        key = (self.solver, self.cfg.iter_size)
        runner = self.runner
        if runner is None or self._runner_for != key \
                or not runner.adopt(carry):
            owner = weakref.proxy(self)  # the solver keeps its runner

            def step(*args, **kw):
                return owner._graph_step(*args, **kw)

            def seed(it: int, i: int) -> int:
                return owner._step_seed(it, i)

            runner = self.runner = StepRunner(
                step, carry, iter_size=self.cfg.iter_size, seed=seed,
                device=self.device, captures=self.captures,
                name="solver step", mesh=self.mesh)
            self._runner_for = key
            self.forwards.drop()
        self.params, self.state, self.opt_state = runner.view()
        return runner

    def step(self, iters: int, *, action_fn=None):
        """Solver::Step (solver.cpp:193-290).  ``action_fn`` is the
        SolverAction poll (signal_handler.cpp): Action.SNAPSHOT to
        checkpoint and continue, Action.STOP to break, polled once per
        iteration (solver.cpp:259-272)."""
        from .signals import Action

        stop = self.iter_ + iters
        self._losses.clear()
        self._smoothed = 0.0
        self._start_iter = self.iter_
        while self.iter_ < stop:
            if action_fn is not None:
                act = action_fn()
                if act == Action.SNAPSHOT:
                    self.snapshot()
                elif act == Action.STOP:
                    # STOP breaks without a snapshot of its own;
                    # snapshot_after_train covers it (solver.cpp:262-271)
                    log.info("Optimization stopped early (signal).")
                    self._early_exit = True
                    break
            with span("solver.step", id=self.iter_):
                self._iteration()
        return self._smoothed

    def _iteration(self):
        """One iteration of ``step``: the test pass due at it, the pull,
        the step's replay, the read of its loss and outputs, the display
        and the snapshot due after it."""
        if (self.test_interval
                and self.iter_ % self.test_interval == 0
                and (self.iter_ > 0 or self.test_initialization)):
            self.test_all()
        for cb in self.callbacks:
            cb[0]()  # on_start
        runner = self._static_carry()   # after what may rebind weights
        with span("solver.pull"):
            batch = self._pull_train_batch()
        # a one-step chunk of the host batch as it is (a net without a
        # feed has none): the stage copies it to the card unstacked
        losses = runner.run({k: v[None] for k, v in batch.items()}
                            if batch else [batch], self.iter_)
        with span("solver.read"):
            # host copies: the next replay overwrites the static outputs
            outs = {k: v.clone() for k, v in runner.outputs.items()}
            loss = float(losses[0])
        self._update_smoothed(loss)
        self.last_outs = outs
        for cb in self.callbacks:
            cb[1]()  # on_gradients_ready
        if self.display and self.iter_ % self.display == 0:
            with span("solver.display"):
                self._display_outputs("Train", outs)
                # sgd_solver.cpp:105's companion line; parse_log reads it
                log.info("Iteration %d, lr = %g", self.iter_,
                         float(learning_rate(self.cfg, self.iter_)))
        self.iter_ += 1
        if self.snapshot_every and self.iter_ % self.snapshot_every == 0:
            self.snapshot()

    def solve(self, *, action_fn=None):
        """Solver::Solve: run to max_iter, final snapshot, final test pass
        (solver.cpp:293-324); an early exit (STOP) snapshots through
        snapshot_after_train and skips the final display and test."""
        self._early_exit = False
        self.step(self.max_iter - self.iter_, action_fn=action_fn)
        if self.snapshot_after_train and (
                self._early_exit
                or not self.snapshot_every
                or self.iter_ % self.snapshot_every != 0):
            self.snapshot()
        if self._early_exit:
            return self._smoothed
        if self.display:
            log.info("Iteration %d, loss = %g", self.iter_, self._smoothed)
        if self.test_interval and self.iter_ % self.test_interval == 0:
            self.test_all()
        return self._smoothed

    def _update_smoothed(self, loss):
        """UpdateSmoothedLoss (solver.cpp:482-495)."""
        if len(self._losses) < self.average_loss:
            self._losses.append(loss)
            n = len(self._losses)
            self._smoothed = (self._smoothed * (n - 1) + loss) / n
        else:
            idx = (self.iter_ - self._start_iter) % self.average_loss
            self._smoothed += (loss - self._losses[idx]) / self.average_loss
            self._losses[idx] = loss

    def _display_outputs(self, tag, outs, *, weights=None, net=None,
                         log_tag=None):
        """``tag`` keys the history record; ``log_tag`` (default ``tag``)
        is what the log line says, so test passes print caffe's `Test net
        output #k:` lines (solver.cpp:397) for parse_log."""
        net = net or self.net
        weights = weights if weights is not None else net.blob_loss_weights()
        log.info("Iteration %d, loss = %g", self.iter_, self._smoothed)
        rec = {"iter": self.iter_, "loss": self._smoothed, "phase": tag}
        score = 0
        for name in outs:
            v_ = outs[name]
            vec = np.ravel(v_.detach().cpu().numpy()
                           if isinstance(v_, torch.Tensor) else np.asarray(v_))
            w = weights.get(name, 0.0)
            for v in vec:
                msg = (f"    {log_tag or tag} net output #{score}: "
                       f"{name} = {v}")
                if w:
                    msg += f" (* {w} = {w * v} loss)"
                log.info("%s", msg)
                score += 1
            rec[name] = float(vec[0]) if vec.size == 1 else vec
        self.history.append(rec)
        if self.on_display:
            self.on_display(rec)
        return rec

    # ------------------------------------------------------------------
    def _shared_test_trees(self, i):
        """ShareTrainedLayersWith by layer name (net.cpp:744-768): the
        train net's params and state win wherever names match."""
        shadow_p, shadow_s = self._test_shadow[i]
        return {**shadow_p, **self.params}, {**shadow_s, **self.state}

    def test_all(self):
        return [self.test(i) for i in range(len(self.test_nets))]

    def _test_forward(self, i, p, s, batch, generator):
        """The plain version of one test batch: test net ``i``'s output
        blobs as float32."""
        blobs, _ = self.test_nets[i].apply(p, s, batch, train=False,
                                           generator=generator)
        return {t: blobs[t].to(torch.float32)
                for t in self.test_nets[i].output_blob_names()}

    def _test_outputs(self, i, p, s, batch, seed):
        """One test batch (host tensors) as one replay of the graph of
        test net ``i`` and the batch's shapes, reading ``p`` and ``s`` in
        place; returns fresh tensors."""
        return self.forwards(
            ("test", i), lambda b, generators: self._test_forward(
                i, p, s, b, generators[0]),
            batch, fixed=(p, s), generators=(seed,))

    @torch.no_grad()
    def _test_outputs_eager(self, i, p, s, batch, seed):
        """``_test_outputs`` as an eager call."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._test_forward(i, p, s, on_device(batch, self.device),
                                  gen)

    def _test_means(self, i, outputs) -> dict:
        """Every output-blob element of test net ``i`` averaged over its
        test_iter batches, each through ``outputs`` (``_test_outputs`` or
        its eager twin); the sum stays on the device, the means are host
        arrays."""
        p, s = self._shared_test_trees(i)
        n = self.test_iters[i] if i < len(self.test_iters) else 1
        total = None
        for t_i in range(n):
            out = outputs(i, p, s, self._host_batch(self._test_feeds[i]),
                          derive_seed(self.seed, _TEST, self.iter_, i, t_i))
            total = out if total is None else tree_map(torch.add, total, out)
        return {k: v.cpu().numpy() / n for k, v in total.items()}

    def test(self, test_net_id: int = 0):
        """Solver::Test (solver.cpp:334-404): average every output-blob
        element over test_iter batches; returns {blob: mean array}.
        Random layers draw as the reference's would at test (a random
        DummyData refills each pass; Dropout is a no-op)."""
        i = test_net_id
        tnet = self.test_nets[i]
        with span("solver.test"):
            self._static_carry()
            mean = self._test_means(i, self._test_outputs)
            # solver.cpp:330's announce line, so the log parses like caffe's
            log.info("Iteration %d, Testing net (#%d)", self.iter_, i)
            self._display_outputs(f"Test#{i}", mean, net=tnet,
                                  weights=tnet.blob_loss_weights(),
                                  log_tag="Test")
        return mean

    # ------------------------------------------------------------------
    def _snapshot_name(self, ext):
        base = os.path.join(self.base_dir, self.snapshot_prefix) \
            if not os.path.isabs(str(self.snapshot_prefix)) \
            else self.snapshot_prefix
        return f"{base}_iter_{self.iter_}{ext}"

    def snapshot(self):
        """Solver::Snapshot: the learned net and the solver state, named
        ``{prefix}_iter_{N}`` (solver.cpp:406-457), in the solver's
        snapshot_format."""
        with span("solver.snapshot"):
            return self._snapshot()

    def _snapshot(self):
        from ..utils.caffemodel import (save_caffemodel_binaryproto,
                                        save_caffemodel_h5,
                                        save_solverstate_binaryproto,
                                        save_solverstate_h5)

        specs = self.net.caffemodel_specs(self.params, self.state)
        h5 = ".h5" if self.snapshot_h5 else ""
        save_model = save_caffemodel_h5 if h5 else \
            save_caffemodel_binaryproto
        save_state = save_solverstate_h5 if h5 else \
            save_solverstate_binaryproto
        model = self._snapshot_name(".caffemodel" + h5)
        st = self._snapshot_name(".solverstate" + h5)
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return model, st  # replicated params: rank 0 writes them
        save_model(model, self.params, self.state, specs=specs)
        save_state(st, self.params, self.state, self.opt_state, self.iter_,
                   learned_net=os.path.basename(model), specs=specs)
        log.info("Snapshotting to %s", model)
        return model, st

    def restore(self, solverstate_path: str):
        """caffe train --snapshot=... (Solver::Restore:470-481): the solver
        history and iteration from the state file, the learned weights from
        its ``learned_net``; every feed restarts and fast-forwards so the
        batch stream continues where the snapshotted run left off."""
        from ..utils.caffemodel import load_solverstate

        specs = self.net.caffemodel_specs(self.params, self.state)
        (self.opt_state, it, _cur, learned,
         _rep) = load_solverstate(solverstate_path, self.params, self.state,
                                  self.opt_state, specs=specs)
        self.iter_ = int(it)
        if learned:
            path = learned if os.path.isabs(learned) else os.path.join(
                os.path.dirname(os.path.abspath(solverstate_path)), learned)
            self.copy_weights(path)
        # train feeds skip the consumed batches; test feeds skip the test
        # passes already run (a snapshot fires after the iter increments,
        # so the pass at iter_ itself replays after restore)
        self._reset_feeds()
        for f in self._feeds:
            f.skip(self.iter_ * self.cfg.iter_size)
        if self.test_interval and self.iter_ >= 1:
            passes = (self.iter_ - 1) // self.test_interval \
                + (1 if self.test_initialization else 0)
            for tid, tfeeds in enumerate(self._test_feeds):
                ti = self.test_iters[tid] if tid < len(self.test_iters) \
                    else 0
                for f in tfeeds:
                    f.skip(passes * ti)
        return self.iter_

    def copy_weights(self, caffemodel_path: str):
        """caffe train --weights=... (CopyTrainedLayersFrom, by layer name;
        binaryproto or HDF5 by the file's magic)."""
        from ..utils.caffemodel import load_caffemodel_auto

        specs = self.net.caffemodel_specs(self.params, self.state)
        self.params, self.state, report = load_caffemodel_auto(
            caffemodel_path, self.params, self.state, specs=specs)
        return report
