"""What each rank runs in ``test_torch_parallel.py``'s multi-process tests
(started by ``parallel.launch.spawn``).  This module imports no JAX, so a
rank starts in seconds; it holds no tests of its own.

Run as a script under torchrun, each rank joins through
``multihost.initialize`` and prints ``card_check()``'s JSON:

    torchrun --standalone --nproc-per-node 2 tests/test_torch_parallel_ranks.py
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
                 device="cpu"):
    """The eval step's probabilities of the initial weights, then ``steps``
    steps of ``build_sharded_train_step`` on a (dp, tp) mesh; returns this
    rank's slices with its tp rank."""
    mesh = make_mesh(dp, tp, devices=device)
    params, state = mms_qa_init(model_cfg,
                                generator=torch.Generator().manual_seed(seed),
                                device=device)
    spec = params_pspec(params, mesh)
    params = shard_pytree(params, mesh, spec)
    solver = make_solver(solver_cfg, param_spec(params, model_cfg))
    opt = solver.init(params)
    step = build_sharded_train_step(model_cfg, solver, mesh)(params, state,
                                                             opt)
    evaluate = build_sharded_eval_step(model_cfg, mesh)
    prob = evaluate(params, state, _tensors(batch, device))
    losses = []
    for i in range(steps):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        params, state, opt, loss = step(params, state, opt,
                                        _tensors(batch, device), i, gen)
        losses.append(float(loss))
    return {"losses": losses, "params": params, "state": state,
            "prob": prob, "tp_rank": mesh.get_local_rank("tp"),
            "spec": spec}


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
        p, s, o, losses = tr.scan_train_steps(*carry, stacked, 0)
        out[mode] = {"params": p, "state": s, "opt": o, "losses": losses,
                     "replays": tr.runner.replays,
                     "tally": [c["tally"] for c in tr.runner.stats()]}
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


def nccl_sharded_step(model_cfg, solver_cfg, batch, params, state, tp,
                      steps=2):
    """``build_sharded_train_step`` on a (1, tp) NCCL mesh: ``steps`` steps
    from ``params`` / ``state`` (numpy; this rank keeps its slices),
    replayed and eager (built with ``captures=False``), under
    ``card_exact``, dropout drawn from one seed."""
    from mms_answer_selection_tpu_torch.convert import params_from_numpy

    card_exact()
    mesh = make_mesh(1, tp, devices="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {"tp_rank": mesh.get_local_rank("tp")}
    for mode in ("replay", "eager"):
        p, s = params_from_numpy(params, state, dev)
        p = shard_pytree(p, mesh, params_pspec(p, mesh))
        solver = make_solver(solver_cfg, param_spec(p, model_cfg))
        o = solver.init(p)
        step = build_sharded_train_step(model_cfg, solver, mesh,
                                        donate=False,
                                        captures=mode == "replay")(p, s, o)
        gen = torch.Generator(device=dev).manual_seed(7)
        losses = []
        for i in range(steps):
            p, s, o, loss = step(p, s, o, b, i, gen)
            losses.append(loss)
        out[mode] = {"params": p, "state": s, "opt": o,
                     "losses": torch.stack(losses)}
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


if __name__ == "__main__":
    import json
    import sys

    from mms_answer_selection_tpu_torch.parallel import multihost

    multihost.initialize()
    # one write of the whole line: the ranks share torchrun's stdout, and
    # a print may write the text and its newline apart (unbuffered), so
    # two ranks' lines could run into one
    sys.stdout.write(json.dumps(card_check()) + "\n")
    sys.stdout.flush()
    torch.distributed.destroy_process_group()
