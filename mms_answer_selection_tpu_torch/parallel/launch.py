"""Run one function in several fresh processes wired into a process group.

``spawn("package.module:function", world_size, kwargs=...)`` starts
``world_size`` Python processes, each of which joins one group through a
file store in a scratch directory (no TCP port to collide with), calls
``function(**kwargs)`` and saves what it returns (``torch.save``; tensors
are moved to the CPU).  The caller gets the results in rank order, or a
``RuntimeError`` with the failed ranks' error output.  Every process is
given ``timeout`` seconds and killed past it, and so is each collective
of its group (a rank left waiting on a peer fails instead of hanging).

Where cards are visible, rank r drives card r modulo their count (its
``LOCAL_RANK``).  More ranks than cards share them only when the caller
passes ``share_device=True``, and only over gloo: NCCL refuses two ranks
on one card.

Usage from a shell, one process per rank:
    python -m mms_answer_selection_tpu_torch.parallel.launch WORKDIR RANK
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

import torch


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def spawn(target: str, world_size: int, *, kwargs: dict | None = None,
          backend: str = "gloo", timeout: float = 120.0,
          pythonpath: list | None = None,
          share_device: bool = False) -> list:
    """Run ``target`` in ``world_size`` processes; returns their results
    in rank order.  ``pythonpath``: directories the processes import
    ``target``'s module from (besides this package's root).
    ``share_device``: let more ranks than the host has cards share them
    (gloo only)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards and world_size > cards and (not share_device
                                         or backend == "nccl"):
        raise ValueError(
            f"{world_size} ranks for {cards} card(s): a rank drives its own "
            f"card; pass share_device=True (gloo only, NCCL refuses two "
            f"ranks on one card) to let ranks share")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="mms_ranks_") as work:
        with open(os.path.join(work, "job.pkl"), "wb") as f:
            pickle.dump({"target": target, "kwargs": kwargs or {},
                         "world_size": world_size, "backend": backend,
                         "timeout": timeout}, f)
        paths = [root] + list(pythonpath or []) + [
            os.environ.get("PYTHONPATH", "")]
        child_env = {**os.environ,
                     "PYTHONPATH": os.pathsep.join(p for p in paths if p)}
        logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
                for r in range(world_size)]
        procs = []
        try:
            # each rank writes to its own file: a pipe could fill while
            # this process waits on another rank, and stall the collective
            for r, log in enumerate(logs):
                env = dict(child_env, LOCAL_RANK=str(r % cards)) if cards \
                    else child_env
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, work, str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"{target} ran past {timeout} s on "
                                       f"{world_size} ranks; killed") \
                        from None
            bad = []
            for r, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode:
                    log.seek(0)
                    bad.append(f"rank {r} exited {p.returncode}:\n"
                               f"{log.read()[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        if bad:
            raise RuntimeError("\n".join(bad))
        return [torch.load(os.path.join(work, f"result{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def _main(work: str, rank: int) -> None:
    import datetime
    import importlib

    import torch.distributed as dist

    from .mesh import bind_device

    with open(os.path.join(work, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    bind_device(rank)
    dist.init_process_group(job["backend"],
                            init_method=f"file://{work}/store",
                            world_size=job["world_size"], rank=rank,
                            timeout=datetime.timedelta(
                                seconds=job["timeout"]))
    try:
        mod, fn = job["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(**job["kwargs"])
        torch.save(_to_cpu(result), os.path.join(work, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
