"""Sharded train and eval steps (counterpart of ``parallel/train_step.py``).

Every rank runs the same step on its share: its rows of the global batch
(dp) and its slice of the embedding rows and metric measures (tp, as
``params_pspec`` splits them; ``shard_pytree`` hands the slices out).  The
model's apply takes the rank's ``ShardContext`` and runs the collectives
(``parallel/collectives.py``); the gradients are then all-reduced over dp
to the global-batch mean, and the solver updates each rank's slice.  A
step over the mesh thus gives the numbers of one step on the global batch,
which ``tests/test_torch_parallel.py`` holds, as the JAX package's tests
hold its own.

Where the JAX package returns ``jax.jit`` of each step, the steps here
are one CUDA graph replay a call on an NCCL mesh, the collectives captured
with them (``training/dispatch.StepRunner`` for the train step,
``utils/graphs.GraphedCall`` for the eval step); on a gloo mesh the same
code runs eagerly on the same static buffers.
"""

from __future__ import annotations

import torch

from ..models.mms_qa import mms_qa_apply
from ..utils.tree import tree_leaves, tree_map
from .collectives import all_reduce_grads, all_reduce_mean, batch_rows, \
    gather_exact
from .mesh import mesh_device, shard_context


def local_batch(batch: dict, shards, axis: int = 0) -> dict:
    """This rank's rows of a global batch (the sample axis ``axis``); a
    batch already local (``multihost.LocalBatch``) passes as it is."""
    from .multihost import LocalBatch
    if shards.dp_size == 1 or isinstance(batch, LocalBatch):
        return batch
    return {k: batch_rows(v, shards.dp_rank, shards.dp_size, axis)
            for k, v in batch.items()}


def loss_and_grads(apply_fn, params, state, batch, model_cfg, generator,
                   shards):
    """(loss, new_state, grads) of this rank's share; the gradients are
    the global batch's once ``reduce_grads`` has run."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    extra = {} if shards is None or (shards.dp_size == 1
                                      and shards.tp_size == 1) \
        else {"shards": shards}
    out, new_state = apply_fn(p, state, batch, model_cfg, train=True,
                              generator=generator, **extra)
    grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(x)
             for g, x in zip(grads, leaves)]
    return out["loss"].detach(), new_state, grads


def reduce_grads(grads: list, loss, shards):
    """The global-batch mean of per-rank gradients and losses over dp."""
    if shards.dp_size == 1:
        return grads, loss
    return (all_reduce_grads(grads, shards.dp_group, shards.dp_size),
            all_reduce_mean(loss, shards.dp_group, shards.dp_size))


def build_sharded_train_step(model_cfg, solver, mesh, *,
                             apply_fn=mms_qa_apply, donate: bool = True,
                             captures: bool = True):
    """Returns ``with_params(params, state, opt_state) -> step``, the JAX
    package's two-stage form; ``step(params, state, opt_state, batch,
    it, generator)`` takes this rank's ``shard_pytree`` slices and the
    GLOBAL batch, and returns (params, state, opt_state, loss).  ``it``:
    an int or a 0-d integer tensor (a device scalar inside the graph).
    The dropout ``generator`` (or None) is seeded alike on every rank;
    the step draws from it and leaves it advanced as an eager step would.

    Each call is one graph replay on an NCCL mesh (module docstring), the
    carry copied into the step's static buffers unless it is the last
    call's result.  ``donate``: as JAX's donated buffers, the returned
    trees are then the static carry itself, which the next call
    overwrites; with False they are clones, and outlive it.
    ``captures``: False runs the steps eagerly on any mesh (the eager
    twin that a replay is held to)."""
    from ..training.dispatch import StepRunner
    from ..utils.graphs import captures_on
    from .multihost import LocalBatch

    shards = shard_context(mesh)
    device = mesh_device(mesh)
    captures = captures and captures_on(device, mesh, "sharded train step")

    def body(params, state, opt_state, batch, it, generator):
        loss, new_state, grads = loss_and_grads(
            apply_fn, params, state, local_batch(batch, shards), model_cfg,
            generator, shards)
        grads, loss = reduce_grads(grads, loss, shards)
        gi = iter(grads)
        params2, opt_state2 = solver.apply(
            params, tree_map(lambda _: next(gi), params), opt_state, it)
        return params2, new_state, opt_state2, loss

    def with_params(params, state, opt_state):
        runners: dict = {}

        def runner_for(carry, drawn: bool, local: bool):
            def one(p, s, o, b, it, generators):
                return body(p, s, o, LocalBatch(b) if local else b, it,
                            generators[0] if drawn else None)

            runner = runners.get((drawn, local))
            if runner is None or not runner.adopt(carry):
                runner = runners[drawn, local] = StepRunner(
                    one, carry, iter_size=1, seed=lambda it, j: 0,
                    device=device, captures=captures, mesh=mesh,
                    name="sharded train step")
            return runner

        def step(params, state, opt_state, batch, it, generator):
            runner = runner_for((params, state, opt_state),
                                generator is not None,
                                isinstance(batch, LocalBatch))
            losses = runner.run(
                [batch], it,
                generators=None if generator is None else [[generator]])
            out = runner.view() if donate else runner.snapshot()
            return (*out, losses[0].clone())

        return step

    return with_params


def build_sharded_eval_step(model_cfg, mesh, *, apply_fn=mms_qa_apply,
                            captures: bool = True):
    """Eval forward over a dp-split global batch: each rank scores its
    rows, and the probabilities of every row come back on every rank.
    One graph replay a call on an NCCL mesh, the gather captured with it;
    the params, state and batch are copied into its static buffers.
    ``captures``: False runs it eagerly on any mesh."""
    from ..utils.graphs import GraphedCall
    from .multihost import LocalBatch

    shards = shard_context(mesh)
    calls = GraphedCall(mesh_device(mesh), captures=captures,
                        name="sharded eval step", mesh=mesh)

    def body(params, state, batch):
        extra = {} if shards.tp_size == 1 else \
            {"shards": shards.without_dp()}
        out, _ = apply_fn(params, state, local_batch(batch, shards),
                          model_cfg, train=False, **extra)
        prob = out["prob"]
        if shards.dp_size == 1:
            return prob
        return gather_exact(prob, shards.dp_group).reshape(
            (-1,) + tuple(prob.shape[1:]))

    def eval_step(params, state, batch):
        local = isinstance(batch, LocalBatch)
        return calls(("eval", local), lambda p, s, b: body(
            p, s, LocalBatch(b) if local else b), params, state, batch)

    return eval_step
