"""Small runs of the benchmark's cells on the CPU, for the tests."""

import time

import torch

from h100_bench import run as harness

QUERY = {"pool": 3000, "chunk_size": 1024, "batch": 8, "query_batches": 3,
         "check_queries": 8, "ref_block": 512}
TRAIN = {"train_pairs": 600, "dev_pairs": 60, "batch": 10,
         "steps_per_dispatch": 5, "test_interval": 10, "warm_steps": 10,
         "trace_steps": 20}


def small_run(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0,
              trace: bool = False, root=harness.ROOT, spec=None):
    """A run of ``workload`` whose traffic is cut to CPU size."""
    spec = spec or harness.read_json(root / "BENCHMARK.json")
    run = harness.Run(spec, workload, seed, seconds, trace, time.time(),
                      root=root)
    run.traffic.update(QUERY if run.traffic["kind"] == "query" else TRAIN)
    return run


def measure(run):
    """Set-up, window and check on the CPU; returns the run."""
    run.device = torch.device("cpu")
    harness.runner(run).measure(run, run.device)
    return run
