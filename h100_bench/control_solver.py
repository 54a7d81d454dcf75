"""The controls and planted faults that the limits of the solver cell's
``correct`` are set against (PERF.md gives their readings).  Not part of a
benchmark run.

    python3 -m h100_bench.control_solver --workload googlenet.solve_lmdb_b32 \
        --seeds 1,2,3 --mode <mode>

prints one JSON line a seed: the readings of ``runners/solver.readings``,
and ``correct`` as the run decides it from them with the mix's limits,
when the plain reference, put in the program's place, is computed so:

* ``control``: in the precision below the configuration's, float32 with
  TF32 on (convolutions and products);
* ``half_batch``: each iteration on the first half of its batch;
* ``unchanged``: a state left unchanged: the weights never move and SGD's
  history stays zero;
* ``zeroed_branch``: inception 4e's pool projection branch's output
  replaced by zeros.

The cell's images are made from each seed as a run makes them, on the
card (or on ``--device``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from h100_bench.reference import googlenet as reference
from h100_bench.run import ROOT, Run, read_json
from h100_bench.runners import solver

MODES = {"control": {"tf32": True}, "half_batch": {"keep": None},
         "unchanged": {"frozen": True},
         "zeroed_branch": {"zero": "inception_4e/pool_proj"}}


def readings(run: Run, dev, mode: str, batch: int | None = None) -> dict:
    cfg, tr = run.config, run.traffic
    sgd, follow = cfg["sgd"], int(tr["follow"])
    batch = batch or int(cfg["batch_size"])
    pixels, labels = solver.images(run.seed, int(cfg["train_images"]),
                                   int(cfg["classes"]), dev)
    ref = reference.train(pixels, labels, run.seed, sgd, batch, follow, dev)
    kw = dict(MODES[mode])
    if mode == "half_batch":
        kw["keep"] = batch // 2
    got = reference.train(pixels, labels, run.seed, sgd, batch, follow, dev,
                          **kw)
    if mode == "unchanged":
        history = {k: torch.zeros_like(v) for k, v in got["init"].items()}
        g_first = solver.first_gradient(history, got["init"], sgd)
        moved = solver.changes(got["init"], got["init"])
    else:
        g_first = {k: float(torch.linalg.vector_norm(g.double()))
                   for k, g in got["grads"].items()}
        moved = solver.changes(got["params"], got["init"])
    return solver.readings(got["losses"], g_first, moved, ref,
                           int(tr["check_losses"]))


def correct(run: Run, readings: dict) -> bool:
    """``correct`` of a run that read ``readings``: each put beside the
    mix's limit, as the runner's check puts it."""
    for name, value in readings.items():
        run.compare(name, value, run.traffic["limits"])
    return run.correct


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.control_solver")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True, choices=sorted(MODES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = read_json(ROOT / "BENCHMARK.json")
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(spec, args.workload, seed, 0.0, False, time.time())
        t0 = time.perf_counter()
        out = readings(run, dev, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "readings": out,
                          "correct": correct(run, out),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
