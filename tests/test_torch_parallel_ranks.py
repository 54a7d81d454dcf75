"""What each rank runs in ``test_torch_parallel.py``'s multi-process tests
(started by ``parallel.launch.spawn``).  This module imports no JAX, so a
rank starts in seconds; it holds no tests of its own.

Run as a script under torchrun, each rank joins through
``multihost.initialize`` and prints ``card_check()``'s JSON:

    torchrun --standalone --nproc-per-node 2 tests/test_torch_parallel_ranks.py

or, given ``cli ARGS``, runs the port's CLI on ``ARGS`` with each HDF5Data
source list read from the prepped ``.npz`` beside it (a host without
h5py; ``npz_for_hdf5_lists``):

    torchrun --standalone --nproc-per-node 4 \
        tests/test_torch_parallel_ranks.py cli solve --solver S --mesh-dp 4
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_init, \
    param_spec
from mms_answer_selection_tpu_torch.parallel import (
    build_sharded_eval_step,
    build_sharded_train_step,
    make_mesh,
    params_pspec,
    shard_pytree,
)
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.training import Trainer
from mms_answer_selection_tpu_torch.training.optim import make_solver


def _tensors(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def trainer_steps(model_cfg, trainer_cfg, batches, params=None, state=None,
                  dp=None, device="cpu"):
    """``Trainer(mesh=)`` steps over the global ``batches``; with
    ``params`` / ``state`` (numpy trees) the run starts from them."""
    mesh = make_mesh(dp, 1, devices=device)
    tr = Trainer(model_cfg, trainer_cfg, mesh=mesh, device=device)
    p, s, o = tr.init()
    if params is not None:
        from mms_answer_selection_tpu_torch.convert import params_from_numpy
        p, s = params_from_numpy(params, state, device)
        o = tr.solver.init(p)
    losses = []
    for i, b in enumerate(batches):
        p, s, o, loss = tr._train_step(p, s, o, _tensors(b, device), i)
        losses.append(float(loss))
    return {"losses": losses, "params": p, "state": s}


def sharded_step(model_cfg, solver_cfg, batch, dp, tp, seed=0, steps=1,
                 device="cpu", params=None, state=None, batches=None):
    """The eval step's probabilities of the initial weights, then ``steps``
    steps of ``build_sharded_train_step`` on a (dp, tp) mesh, each on
    ``batch`` (or one step on each of ``batches``), then the eval step's
    probabilities of the trained weights on ``batch``; returns this
    rank's slices (params and solver history) with its place on the
    mesh.  ``params`` / ``state``: numpy trees to start from, else the
    port's init from ``seed``."""
    mesh = make_mesh(dp, tp, devices=device)
    if params is None:
        params, state = mms_qa_init(
            model_cfg, generator=torch.Generator().manual_seed(seed),
            device=device)
    else:
        from mms_answer_selection_tpu_torch.convert import params_from_numpy
        params, state = params_from_numpy(params, state, device)
    spec = params_pspec(params, mesh)
    params = shard_pytree(params, mesh, spec)
    solver = make_solver(solver_cfg, param_spec(params, model_cfg))
    opt = solver.init(params)
    step = build_sharded_train_step(model_cfg, solver, mesh,
                                    donate=False)(params, state, opt)
    evaluate = build_sharded_eval_step(model_cfg, mesh)
    prob = evaluate(params, state, _tensors(batch, device))
    losses = []
    for i, b in enumerate(batches if batches is not None
                          else [batch] * steps):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        params, state, opt, loss = step(params, state, opt,
                                        _tensors(b, device), i, gen)
        losses.append(float(loss))
    return {"losses": losses, "params": params, "state": state,
            "opt": opt, "prob": prob,
            "prob_after": evaluate(params, state, _tensors(batch, device)),
            "tp_rank": mesh.get_local_rank("tp"),
            "dp_rank": mesh.get_local_rank("dp"), "spec": spec}


def engine_topk(params, model_cfg, cand, queries, k, pool_dtype, chunk_size,
                remove=(), device="cpu"):
    """A meshed engine's top-k over ``cand`` (split over every rank)."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    mesh = make_mesh(devices=device)
    eng = QueryEngine(params_from_numpy(params, {}, device)[0], model_cfg,
                      pool_dtype=pool_dtype, chunk_size=chunk_size,
                      mesh=mesh, device=device).build_index(cand)
    if len(remove):
        eng.remove_candidates(np.asarray(remove))
    vals, idx = eng.query(torch.as_tensor(queries), k=k)
    return {"vals": vals, "idx": idx}


def graph_solver_steps(solver_text, feeds, steps, dp=None, device="cpu"):
    """``GraphSolver(mesh=)`` steps over the global batches of ``feeds``;
    the per-step losses and the trained params."""
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver
    mesh = make_mesh(dp, 1, devices=device)
    gs = GraphSolver(solver_text, feeds=feeds, device=device, mesh=mesh)
    losses = [float(gs._train_step()[0]) for _ in range(steps)]
    return {"losses": losses, "params": gs.params, "state": gs.state}


def multihost_checks(rows, device="cpu"):
    """``host_shard``, ``global_mesh`` and ``global_batch_from_local`` on
    this rank; ``rows`` is this rank's local batch size per rank."""
    import torch.distributed as dist

    from mms_answer_selection_tpu_torch.parallel import multihost
    from mms_answer_selection_tpu_torch.parallel.mesh import mesh_shape
    out = {"shard": multihost.host_shard()}
    mesh = multihost.global_mesh(1, devices=device)
    out["mesh"] = mesh_shape(mesh)
    n = rows[dist.get_rank()]
    try:
        lb = multihost.global_batch_from_local(
            mesh, {"x": np.full((n, 2), dist.get_rank(), np.float32)})
        out["local"] = (type(lb).__name__, lb["x"])
    except ValueError as e:
        out["error"] = str(e)
    return out


def merge_ties(device="cpu"):
    """The meshed query's merge on crafted per-rank top-k lists: ties
    across ranks, and -0.0 against +0.0."""
    import torch.distributed as dist

    from mms_answer_selection_tpu_torch.parallel.collectives import \
        gather_exact
    from mms_answer_selection_tpu_torch.serve.query_engine import topk_merge
    r = dist.get_rank()
    vals = torch.tensor([[1.0, 0.5, -0.0]] if r == 0 else [[1.0, 0.0, 0.5]],
                        device=device)
    idx = torch.tensor([[0, 1, 2]] if r == 0 else [[10, 11, 12]],
                       device=device)
    group = dist.group.WORLD
    v, i = topk_merge(gather_exact(vals, group), gather_exact(idx, group), 6)
    return {"vals": v, "idx": i}


def engine_save_load(params, model_cfg, cand, queries, root, device="cpu"):
    """A split pool saved one file a rank and reloaded into a fresh engine
    on the same mesh: the top-k before and after."""
    import torch.distributed as dist

    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    mesh = make_mesh(devices=device)
    p = params_from_numpy(params, {}, device)[0]
    eng = QueryEngine(p, model_cfg, pool_dtype="int8", mesh=mesh,
                      device=device).build_index(cand)
    eng.remove_candidates([1])
    path = f"{root}/pool.{dist.get_rank()}.npz"
    eng.save_index(path)
    back = QueryEngine(p, model_cfg, pool_dtype="int8", mesh=mesh,
                       device=device).load_index(path)
    q = torch.as_tensor(queries)
    return {"before": eng.query(q, k=5), "after": back.query(q, k=5),
            "path": path}


# ---------------------------------------- NCCL ranks, one card each
def card_exact() -> None:
    """float32 on the card as the bit-for-bit checks need it: no TF32, and
    torch's deterministic kernels (the embedding gradient's scatter sums
    in one order; by default two eager steps part in the last bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)


def p50_in_turns(eager, replay, reps: int) -> dict:
    """{"eager": ms, "replay": ms}: each the mean over two turns (eager,
    replay, replay, eager) of the median of ``reps`` calls, each call
    ended by a device sync, after one call off the clock."""
    import statistics
    import time

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    turns = {"eager": [], "replay": []}
    for mode in ("eager", "replay", "replay", "eager"):
        turns[mode].append(median_ms(eager if mode == "eager" else replay))
    return {m: sum(t) / 2 for m, t in turns.items()}


def serving_model(cfg, seed: int = 0):
    """Float32 numpy (params, state) of ``cfg`` from ``seed``, a random
    metric W (the init's W is 0), the same in every process."""
    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    params["sim"]["w"] = torch.randn(
        params["sim"]["w"].shape,
        generator=torch.Generator().manual_seed(seed + 1)) * 0.05
    return ({k: {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in params.items()},
            {k: {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in state.items()})


def candidates(rows: int, width: int, vocab: int, seed: int):
    """(rows, width) int64 token ids from ``seed``, alike everywhere."""
    return torch.randint(0, vocab, (rows, width),
                         generator=torch.Generator().manual_seed(seed))


def nccl_trainer_chunk(model_cfg, trainer_cfg, batches, params, state,
                       timed=(), reps=20, alone=None):
    """``Trainer(mesh=)`` over every rank (NCCL): one chunk of
    ``len(batches)`` steps from ``params`` / ``state`` (numpy), once
    replayed and once eager (the trainer's ``captures`` off), under
    ``card_exact``; then for each global batch in ``timed`` a one-step
    chunk's p50, eager and replayed in turns.  Last, the other ranks
    return, and rank 0 alone evaluates the replayed chunk's params on the
    split ``alone`` (numpy), as ``cli train`` does on its test split: the
    replayed and the eager eval, and the eval's replays."""
    import dataclasses

    from mms_answer_selection_tpu_torch.convert import params_from_numpy

    card_exact()
    mesh = make_mesh(devices="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())

    def trainer(replay, cfg=trainer_cfg):
        tr = Trainer(model_cfg, cfg, mesh=mesh)
        tr.captures = replay          # read when its runner is made
        tr.init()
        p, s = params_from_numpy(params, state, dev)
        return tr, (p, s, tr.solver.init(p))

    stacked = {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
               .to(dev) for k in batches[0]}
    out, trained = {}, {}
    for mode in ("replay", "eager"):
        tr, carry = trainer(mode == "replay")
        trained[mode] = tr
        tr._runner_for(carry).keep_graphs = True
        p, s, o, losses = tr.scan_train_steps(*carry, stacked, 0)
        out[mode] = {"params": p, "state": s, "opt": o, "losses": losses,
                     "replays": tr.runner.replays,
                     "tally": [c["tally"] for c in tr.runner.stats()]}
    out["nodes"] = graph_kernel_nodes(trained["replay"].runner,
                                      len(batches))
    torch.use_deterministic_algorithms(False)     # times as users run
    out["times"] = {}
    for batch in timed:
        n = len(batch["label"])
        tr, carry = trainer(True, dataclasses.replace(trainer_cfg,
                                                      batch_size=n))
        runner = tr._runner_for(carry)
        one = [{k: torch.as_tensor(v, device=dev) for k, v in batch.items()}]

        def run(flag):
            def call():
                runner.captures = flag
                runner.run(one, 0)
            return call

        out["times"][n] = p50_in_turns(run(False), run(True), reps)
    if alone is not None and dist.get_rank() == 0:
        card_exact()
        tr = trained["replay"]
        p, s = out["replay"]["params"], out["replay"]["state"]
        got = tr.evaluate(p, s, alone)
        replays = tr.evals.replays
        tr.evals.captures = False
        out["alone"] = {"replay": got, "eager": tr.evaluate(p, s, alone),
                        "replays": replays}
    return out


def graph_kernel_nodes(runner, k: int) -> dict:
    """The pair-map kernels' nodes in ``runner``'s captured ``k``-step
    graph (its ``keep_graphs`` set before the capture), read from the
    graph itself."""
    from mms_answer_selection_tpu_torch.utils.graphs import kernel_nodes

    return kernel_nodes(runner.graph(k), [n + "_kernel" for n in (
        "pair_maps_fwd", "pair_maps_bwd_w", "pair_maps_bwd_qa")])


def nccl_sharded_step(model_cfg, solver_cfg, batch, params, state, tp,
                      steps=2, dp=1, batches=None, timed=(), reps=20):
    """``build_sharded_train_step`` on a (dp, tp) NCCL mesh: ``steps``
    steps on ``batch`` (or one on each of ``batches``; global batches)
    from ``params`` / ``state`` (numpy; this rank keeps its slices),
    replayed and eager (built with ``captures=False``), under
    ``card_exact``, dropout drawn from one seed; the pair-map kernels'
    nodes in the replayed step's graph.  Then for each global batch in
    ``timed`` the step's p50, eager and replayed in turns."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.training import dispatch

    card_exact()
    mesh = make_mesh(dp, tp, devices="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())

    def on_card(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    runners = []
    made = dispatch.StepRunner.__init__

    def keep(self, *a, **kw):       # the step's runner keeps its graphs
        made(self, *a, **kw)
        self.keep_graphs = True
        runners.append(self)

    def build(captures, donate=False):
        p, s = params_from_numpy(params, state, dev)
        p = shard_pytree(p, mesh, params_pspec(p, mesh))
        solver = make_solver(solver_cfg, param_spec(p, model_cfg))
        o = solver.init(p)
        return build_sharded_train_step(model_cfg, solver, mesh,
                                        donate=donate,
                                        captures=captures)(p, s, o), (p, s, o)

    out = {"tp_rank": mesh.get_local_rank("tp"),
           "dp_rank": mesh.get_local_rank("dp"),
           "spec": params_pspec(params_from_numpy(params, {}, "cpu")[0],
                                mesh)}
    for mode in ("replay", "eager"):
        dispatch.StepRunner.__init__ = keep
        try:
            step, (p, s, o) = build(mode == "replay")
            gen = torch.Generator(device=dev).manual_seed(7)
            losses = []
            for i, b in enumerate(batches if batches is not None
                                  else [batch] * steps):
                p, s, o, loss = step(p, s, o, on_card(b), i, gen)
                losses.append(loss)
        finally:
            dispatch.StepRunner.__init__ = made
        out[mode] = {"params": p, "state": s, "opt": o,
                     "losses": torch.stack(losses)}
        if mode == "replay":
            (runner,) = runners
            out["replays"] = runner.replays
            out["nodes"] = graph_kernel_nodes(runner, 1)
    torch.use_deterministic_algorithms(False)     # times as users run
    out["times"] = {}
    for b in timed:
        b = on_card(b)
        calls = {}
        for mode in ("eager", "replay"):
            step, carry = build(mode == "replay", donate=True)
            gen = torch.Generator(device=dev).manual_seed(7)
            carry = step(*carry, b, 0, gen)[:3]     # the static carry

            def call(step=step, carry=carry, gen=gen):
                step(*carry, b, 0, gen)
            calls[mode] = call
        out["times"][len(b["label"])] = p50_in_turns(
            calls["eager"], calls["replay"], reps)
    return out


def nccl_engine(model_cfg, params, pools, queries, k, chunk_size,
                timed_nq=(), reps=10):
    """``QueryEngine(mesh=)`` over every rank (NCCL), for each (pool
    dtype, rows, seed) in ``pools``: the top-k of each query count in
    ``timed_nq``, replayed and eager (the engine's graphs off), the
    replays made and the MaxSim launches, and each count's p50 eager and
    replayed in turns."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    mesh = make_mesh(devices="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    p = params_from_numpy(params, {}, dev)[0]
    q = torch.as_tensor(queries, device=dev)
    out = {}
    for pool_dtype, rows, seed in pools:
        card_exact()
        eng = QueryEngine(p, model_cfg, pool_dtype=pool_dtype,
                          chunk_size=chunk_size, mesh=mesh).build_index(
            candidates(rows, model_cfg.answer_len, model_cfg.vocab_size,
                       seed))
        calls = eng._calls

        def query(nq, flag):
            def call():
                calls.captures = flag
                return eng.query(q[:nq], k=k)
            return call

        res = {"captures": calls.captures}
        for name in sk.LAUNCH_COUNTS:
            sk.LAUNCH_COUNTS[name] = 0
        for nq in timed_nq:
            res[nq] = {"eager": query(nq, False)(),
                       "replay": [query(nq, True)() for _ in range(2)]}
        res["launches"] = {n: c for n, c in sk.LAUNCH_COUNTS.items() if c}
        res["replays"] = calls.replays
        torch.use_deterministic_algorithms(False)     # times as users run
        res["times"] = {nq: p50_in_turns(query(nq, False), query(nq, True),
                                         reps) for nq in timed_nq}
        out[pool_dtype, rows] = res
        del eng, calls
        torch.cuda.empty_cache()
    return out


def local_rank() -> str | None:
    """The card index ``parallel.launch`` handed this rank."""
    import os

    return os.environ.get("LOCAL_RANK")


def card_check() -> dict:
    """The card this rank drives, and an NCCL all-reduce of ones over the
    ranks, on the mesh's device."""
    import torch.distributed as dist

    from mms_answer_selection_tpu_torch.parallel.mesh import mesh_device

    mesh = make_mesh(devices="cuda")
    x = torch.ones(1, device=mesh_device(mesh))
    dist.all_reduce(x)
    return {"card": torch.cuda.current_device(), "sum": float(x)}


def npz_for_hdf5_lists() -> None:
    """Read an HDF5Data source list ``<name>.txt`` as the prepped
    ``<name>.npz`` beside it (``data.load_dataset``), for a host without
    h5py: ``cli prep`` writes ``train.npz``, whose arrays are those the
    list's chunks would hold."""
    import os

    from mms_answer_selection_tpu_torch.data import hdf5_compat, \
        load_dataset

    hdf5_compat.load_hdf5_list = lambda path: load_dataset(
        os.path.splitext(path)[0] + ".npz")


if __name__ == "__main__":
    import json
    import sys

    from mms_answer_selection_tpu_torch.parallel import multihost

    if sys.argv[1:2] == ["cli"]:
        from mms_answer_selection_tpu_torch import cli

        npz_for_hdf5_lists()
        cli.main(sys.argv[2:])
        sys.exit(0)
    multihost.initialize()
    # one write of the whole line: the ranks share torchrun's stdout, and
    # a print may write the text and its newline apart (unbuffered), so
    # two ranks' lines could run into one
    sys.stdout.write(json.dumps(card_check()) + "\n")
    sys.stdout.flush()
    torch.distributed.destroy_process_group()
