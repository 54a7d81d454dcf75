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
"""

from __future__ import annotations

import torch

from ..models.mms_qa import mms_qa_apply
from ..utils.tree import tree_leaves, tree_map
from .collectives import all_reduce_grads, all_reduce_mean, batch_rows, \
    gather_exact
from .mesh import shard_context


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
                             apply_fn=mms_qa_apply, donate: bool = True):
    """Returns ``with_params(params, state, opt_state) -> step``, the JAX
    package's two-stage form; ``step(params, state, opt_state, batch,
    it, generator)`` takes this rank's ``shard_pytree`` slices and the
    GLOBAL batch, and returns (params, state, opt_state, loss).  The
    dropout ``generator`` is seeded alike on every rank.  ``donate`` is
    taken for the JAX package's signature; eager steps have no buffers to
    donate."""
    del donate
    shards = shard_context(mesh)

    def step(params, state, opt_state, batch, it, generator):
        loss, new_state, grads = loss_and_grads(
            apply_fn, params, state, local_batch(batch, shards), model_cfg,
            generator, shards)
        grads, loss = reduce_grads(grads, loss, shards)
        gi = iter(grads)
        params2, opt_state2 = solver.apply(
            params, tree_map(lambda _: next(gi), params), opt_state, int(it))
        return params2, new_state, opt_state2, loss

    def with_params(params, state, opt_state):
        return step

    return with_params


def build_sharded_eval_step(model_cfg, mesh, *, apply_fn=mms_qa_apply):
    """Eval forward over a dp-split global batch: each rank scores its
    rows, and the probabilities of every row come back on every rank."""
    shards = shard_context(mesh)

    @torch.no_grad()
    def eval_step(params, state, batch):
        extra = {} if shards.tp_size == 1 else \
            {"shards": shards.without_dp()}
        out, _ = apply_fn(params, state, local_batch(batch, shards),
                          model_cfg, train=False, **extra)
        prob = out["prob"]
        if shards.dp_size == 1:
            return prob
        return gather_exact(prob, shards.dp_group).reshape(
            (-1,) + tuple(prob.shape[1:]))

    return eval_step
