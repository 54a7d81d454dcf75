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

    from mms_answer_selection_tpu_torch.parallel import multihost

    multihost.initialize()
    print(json.dumps(card_check()), flush=True)
    torch.distributed.destroy_process_group()
