"""The collectives a (dp, tp) step runs, and the context that carries the
groups into a model's apply.

The JAX package states a layout (``PartitionSpec`` per array) and lets
XLA insert the collectives under ``jit``.  Here every rank is a process
holding its own shard, so the collectives are explicit:

* dp: BatchNorm's batch sums are all-reduced over the dp group with a
  collective that has a backward (``torch.distributed.nn.functional``), so
  the statistics are the global batch's, as JAX's ``bn_apply`` under a
  dp-sharded ``jit`` computes them; the gradients are all-reduced to the
  global-batch mean after the backward.
* tp: the embedding rows and the bilinear metric's measures are split
  over the tp ranks.  A lookup is all-reduced and a measure slice
  all-gathered; downstream of both, every tp rank computes the same, so
  their backwards are the identity and the slice, while the embeddings
  entering the measure slices take the sum of the slices' gradients
  (Megatron's f / g pair).

Gathers are all-reduces of a zeroed buffer in which each rank fills its
own slot: gloo on CUDA tensors offers ``all_reduce`` for certain, and a
sum of one value and zeros is that value exactly (bit patterns are summed
as integers where even -0.0 must survive).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """This rank's place on a (dp, tp) mesh: the groups and the positions
    a model's apply needs.  ``dp_size == tp_size == 1`` is the plain,
    unsharded path."""
    dp_group: object = None
    dp_rank: int = 0
    dp_size: int = 1
    tp_group: object = None
    tp_rank: int = 0
    tp_size: int = 1

    @property
    def batch_shard(self):
        """(index, count) of this rank's rows of the global batch, or
        ``None`` when the batch is not split."""
        return (self.dp_rank, self.dp_size) if self.dp_size > 1 else None

    def without_dp(self) -> "ShardContext":
        """The same tp layout over an unsplit batch (the eval forward)."""
        return dataclasses.replace(self, dp_group=None, dp_rank=0, dp_size=1)

    def without_tp(self) -> "ShardContext":
        """The same batch split with every parameter whole (the tp ranks
        then compute alike)."""
        return dataclasses.replace(self, tp_group=None, tp_rank=0, tp_size=1)


def batch_rows(x: torch.Tensor, index: int, count: int, axis: int = 0):
    """Rows [index * n / count, (index + 1) * n / count) of ``x`` along
    ``axis``; ``n`` must divide."""
    n = x.shape[axis]
    if n % count:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"{count} dp ranks")
    per = n // count
    return x.narrow(axis, index * per, per)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) with a backward that all-reduces the gradient: the
    collective for statistics that every rank's loss reads."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


class _ReduceFromTP(torch.autograd.Function):
    """Forward: sum over the tp group.  Backward: the identity, since
    every tp rank computes the same downstream."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """Forward: the identity.  Backward: sum over the tp group: the input
    of an op that each tp rank runs on its own slice of the weights, whose
    gradient is the sum of every slice's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _gather_slots(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` in rank order, by an
    all-reduce of a zeroed buffer each rank fills at its own slot."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    buf = torch.zeros((size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[rank] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


class _GatherLastFromTP(torch.autograd.Function):
    """Forward: concatenate every tp rank's slice along the last axis.
    Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        slots = _gather_slots(x.contiguous(), group)
        return torch.cat(list(slots.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(-1, r * ctx.width, ctx.width).contiguous(), None


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def gather_last_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherLastFromTP.apply(x, group)


def gather_exact(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape) of every rank's ``x``, bit for bit: float32 travels
    as its int32 bit pattern, so -0.0 and every NaN payload arrive
    unchanged."""
    if x.dtype == torch.float32:
        return _gather_slots(x.contiguous().view(torch.int32),
                             group).view(torch.float32)
    return _gather_slots(x.contiguous(), group)


def sharded_embed_lookup(params, ids: torch.Tensor, vocab: int,
                         shards: ShardContext) -> torch.Tensor:
    """``embed_lookup`` over a table whose rows are split over the tp
    ranks: this rank looks up the ids in its rows (others masked to 0),
    the partial lookups are summed over the tp group, then the shared bias
    is added.  Ids clamp into [0, vocab - 1] as the unsplit lookup does."""
    w = params["w"]
    rows = w.shape[0]
    ids = ids.to(device=w.device, dtype=torch.int64).clamp(0, vocab - 1)
    local = ids - shards.tp_rank * rows
    mine = (local >= 0) & (local < rows)
    out = w[local.clamp(0, rows - 1)] * mine.unsqueeze(-1).to(w.dtype)
    out = reduce_from_tp(out, shards.tp_group)
    if "b" in params:
        out = out + params["b"]
    return out


def all_reduce_grads(grads: list, group, size: int) -> list:
    """Each gradient summed over ``group`` and divided by ``size``: the
    global-batch mean from per-rank means of equal batches.  One flat
    buffer per dtype, one collective each."""
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / size
        pos = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[pos:pos + n].view_as(grads[i])
            pos += n
    return out


def all_reduce_mean(x: torch.Tensor, group, size: int) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y / size
