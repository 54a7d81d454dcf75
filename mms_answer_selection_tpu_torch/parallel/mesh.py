"""Device mesh and sharding rules (counterpart of ``parallel/mesh.py``).

The JAX package declares a ``Mesh`` and a ``PartitionSpec`` per array and
lets ``jit`` place the collectives.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one device a rank, with the JAX package's axis names:

  dp -- data parallel: each rank takes its rows of the global batch, and
        the gradients are all-reduced to the global-batch mean
  tp -- tensor parallel: the embedding table's rows and the bilinear
        metric's measures are split over the tp ranks

Each rank drives its own card: ``bind_device`` makes the launcher's
``LOCAL_RANK`` (else the rank modulo the host's cards) the current CUDA
device before the first collective.  ``multihost.initialize``,
``launch.spawn`` and ``make_mesh`` call it.

A spec is a tuple of axis names, as ``tuple(PartitionSpec(...))`` gives
it: ``("tp",)`` splits a leaf's first axis over tp, ``()`` replicates it.
``shard_pytree`` hands each rank its slice; there is no global array.

Programs over a mesh run as CUDA graph replays where ``mesh_captures``
holds: the mesh is on the card and every group its collectives use (the
whole mesh's, dp and tp) is NCCL, whose collectives a graph records.  A
gloo collective on a CUDA tensor waits on the host, which no capture
allows, so gloo meshes (the CPU's, or ranks sharing one card) run the same
programs eagerly.  A capture records a collective without running it:
every rank must capture, and later replay, the same program at the same
call, or the ranks' collectives stop matching and the run hangs; the
owners key such programs on nothing rank-local, so every rank captures
at the same call (``utils/graphs``).  An NCCL communicator is made at
its group's first collective, which a capture cannot hold: the owners'
warm-up call before each capture runs every collective of the program
once, which makes them.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from .collectives import ShardContext


def _device_type(devices) -> str:
    if devices is None:
        return resolve_device(None).type
    if isinstance(devices, (list, tuple)):
        return torch.device(devices[0]).type
    return torch.device(devices).type


def local_device_index(rank: int) -> int:
    """The card a rank drives: the launcher's ``LOCAL_RANK`` where it set
    one (torchrun and ``parallel.launch`` do), else the rank modulo the
    cards this host sees (ranks numbered host by host)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % torch.cuda.device_count()


def bind_device(rank: int) -> torch.device | None:
    """Make this rank's card the current CUDA device, so that NCCL, the
    mesh and every tensor the rank makes on "cuda" use it; ``None`` where
    no card is visible."""
    if not torch.cuda.is_available():
        return None
    index = local_device_index(rank)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _ensure_process_group(device_type: str) -> None:
    """A one-process group (NCCL on the card, gloo on the CPU) when none
    is initialized, so a mesh of one device needs no wiring."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(dp: int | None = None, tp: int = 1, *,
              devices=None) -> DeviceMesh:
    """Build a (dp, tp) mesh over the process group's ranks; dp defaults
    to the rank count // tp.  ``devices``: the device type ("cuda", the
    default, or "cpu"), or a list with one device a rank.  Without a
    process group, a one-process group is made."""
    device_type = _device_type(devices)
    _ensure_process_group(device_type)
    n = dist.get_world_size()
    if isinstance(devices, (list, tuple)) and len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for {n} ranks; a "
                         f"rank drives one device")
    if device_type == "cuda" and n > 1:
        if isinstance(devices, (list, tuple)):
            torch.cuda.set_device(torch.device(devices[dist.get_rank()]))
        else:
            bind_device(dist.get_rank())
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def _cuda_backend(group) -> str:
    """The backend ``group`` runs CUDA tensors' collectives on (a group
    made as "cpu:gloo,cuda:nccl" names one per device type)."""
    name = dist.get_backend(group)
    for part in name.split(","):
        dev, _, backend = part.rpartition(":")
        if dev in ("", "cuda"):
            return backend
    return name


def mesh_captures(mesh) -> bool:
    """Whether programs over ``mesh`` may be captured as CUDA graphs: the
    mesh is on "cuda" and every group its programs run collectives on is
    NCCL: the whole mesh's (the default group: a mesh spans every rank)
    and each axis'."""
    groups = [dist.group.WORLD] + [mesh.get_group(a)
                                   for a in mesh.mesh_dim_names]
    return mesh.device_type == "cuda" and all(
        _cuda_backend(g) == "nccl" for g in groups)


def mesh_shape(mesh) -> dict:
    """{'dp': n, 'tp': m}, as ``Mesh.shape`` reads in the JAX package."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def shard_context(mesh) -> ShardContext:
    """This rank's groups and positions on ``mesh`` (``None``: the plain
    path)."""
    if mesh is None:
        return ShardContext()
    names = mesh.mesh_dim_names
    ctx = {}
    for axis in ("dp", "tp"):
        if axis in names:
            ctx[f"{axis}_group"] = mesh.get_group(axis)
            ctx[f"{axis}_rank"] = mesh.get_local_rank(axis)
            ctx[f"{axis}_size"] = mesh.size(names.index(axis))
    return ShardContext(**ctx)


def mesh_device(mesh) -> torch.device:
    """The device this rank drives on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def params_pspec(params, mesh=None, *, tp_axis: str = "tp"):
    """Spec tree for the MMS model family, the JAX package's rule:

    * the embedding table (V, D): rows over tp when tp divides V
    * the bilinear metric W (M, D, D): measures over tp when tp divides M
    * everything else replicated.
    """
    tp = mesh_shape(mesh).get(tp_axis, 1) if mesh is not None else 1

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if "embed" in keys and keys[-1] == "w" and node.shape[0] % tp == 0:
            return (tp_axis,)
        if ("sim" in keys and keys[-1] == "w" and node.ndim == 3
                and node.shape[0] % tp == 0):
            return (tp_axis,)
        return ()

    return walk(params, ())


def shard_pytree(tree, mesh, pspec_tree):
    """Each leaf on this rank's device: its tp slice along axis 0 where the
    spec says ``("tp",)``, whole where it says ``()``."""
    ctx, dev = shard_context(mesh), mesh_device(mesh)

    def put(x, spec):
        if isinstance(x, dict):
            return {k: put(x[k], spec[k]) for k in x}
        x = torch.as_tensor(x).to(dev)
        if spec and spec[0] == "tp" and ctx.tp_size > 1:
            per = x.shape[0] // ctx.tp_size
            x = x[ctx.tp_rank * per:(ctx.tp_rank + 1) * per].clone()
        return x

    return put(tree, pspec_tree)
