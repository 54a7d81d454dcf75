"""Multi-process wiring (counterpart of ``parallel/multihost.py``).

Every process runs the same program; ``initialize`` wires them into one
``torch.distributed`` process group, ``global_mesh`` spans every process's
device, and each process feeds its own rows (``host_shard`` stripes a
batch iterator across processes, the DataReader round-robin of
data_reader.cpp:79-98 done across processes).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import bind_device, make_mesh

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None):
    """``torch.distributed.init_process_group`` with the JAX package's
    contract.  Nothing asked and no launcher's environment
    (``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK``): a no-op, the job runs as
    one process.  Explicit wiring (``coordinator_address``, e.g.
    ``tcp://host:port`` or ``host:port``, ``num_processes``,
    ``process_id``): a failure propagates, since a job that asked for a
    cluster must not go on as one process.  ``backend`` defaults to NCCL
    where a card is visible, else gloo.  Where a card is visible, the
    process is bound to its own (``mesh.bind_device``: ``LOCAL_RANK``,
    else the rank modulo the host's cards) before the group is made."""
    explicit = coordinator_address is not None or num_processes is not None
    if dist.is_initialized():
        if dist.get_world_size() > 1 or not explicit \
                or int(num_processes or 1) == 1:
            return
        raise RuntimeError(
            "multihost.initialize(coordinator_address=...) was asked for "
            f"{num_processes} processes, but this process already joined a "
            "one-process group")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if not explicit:
        if not all(k in os.environ for k in _ENV):
            return  # single process, nothing requested: no-op
        bind_device(int(os.environ["RANK"]))
        dist.init_process_group(backend, init_method="env://")
        return
    addr = coordinator_address
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    bind_device(int(process_id or 0))
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id or 0))


def host_shard() -> tuple[int, int]:
    """(process index, process count): feed ``BatchIterator(shard=...)``
    or ``NativePrefetcher(shard=...)`` with it to stripe rows across
    processes."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(tp: int = 1, *, devices=None):
    """A dp x tp mesh over every process's device (one device a process)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % tp:
        raise ValueError(f"{n} global devices not divisible by tp={tp}")
    return make_mesh(n // tp, tp, devices=devices)


class LocalBatch(dict):
    """A batch of this process's rows only.  Steps over a mesh take it as
    this rank's share, where they split any other batch themselves."""


def global_batch_from_local(mesh, local_batch: dict) -> LocalBatch:
    """This process's rows as its share of a logically global batch whose
    rows run in process order.  The JAX package assembles a global
    ``jax.Array`` from the local shards; torch has no global array, so the
    batch stays this process's tensors, and the check is that every
    process holds the same number of rows (a dp step needs equal shares
    to take the global-batch mean)."""
    rows = {int(torch.as_tensor(v).shape[0]) for v in local_batch.values()}
    if len(rows) != 1:
        raise ValueError(f"local batch leaves disagree on rows: {rows}")
    n = rows.pop()
    if dist.is_initialized() and dist.get_world_size() > 1:
        from .mesh import mesh_device
        counts = torch.zeros(dist.get_world_size(), dtype=torch.int64,
                             device=mesh_device(mesh))
        counts[dist.get_rank()] = n
        dist.all_reduce(counts)
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"processes hold different local batch sizes "
                             f"{counts.tolist()}; a dp step needs equal "
                             f"shares")
    return LocalBatch({k: torch.as_tensor(v) for k, v in
                       local_batch.items()})
