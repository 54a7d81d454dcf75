"""The controls and planted faults that the limits of ``correct`` are set
against (PERF.md gives their readings).  Not part of a benchmark run.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 --mode <mode>

prints one JSON line a seed: the readings of ``judge`` when the
reference, put in the program's place, is computed so:

* ``control``: in the precision below the configuration's: an int8 pool
  scored as int4, a bf16 pool as int8, float32 training with TF32 on;
* ``answer_altered`` (retrieval): the reference's own lists with each
  query's first candidate replaced by the next row of the pool;
* ``half_batch`` (training): each step on the first half of its batch,
  the mean loss over those rows;
* ``no_exchange`` (training over several cards): each step on rank 0's
  rows alone, as a rank whose gradients and BN sums are never exchanged.

The cell's inputs are made from each seed as a run makes them, at the
cell's own sizes, on the card (or on ``--device``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from h100_bench import judge, port, traffic
from h100_bench.runners import query
from h100_bench.reference import plain
from h100_bench.run import ROOT, Run, read_json

LOWER = {"int8": "int4", "bf16": "int8"}


def query_readings(run: Run, dev, mode: str) -> dict:
    cfg, tr = run.config, run.traffic
    shapes = dict(tr, vocab_size=cfg["vocab_size"])
    params = port.serving_weights(cfg, run.seed, dev)
    ids = traffic.candidates(run.seed, shapes, dev)
    batches = traffic.query_batches(run.seed, shapes, dev)
    nq, k = batches.shape[1], int(tr["k"])
    picks = traffic.sample(run.seed, batches.shape[0] * nq,
                           int(tr["check_queries"]))
    q_ids = torch.stack([batches[p // nq][p % nq] for p in picks])
    ref = query.reference_scores(run, params, ids, q_ids, tr["pool_dtype"])
    if mode == "control":
        got = query.reference_scores(run, params, ids, q_ids,
                                     LOWER[tr["pool_dtype"]])
    elif mode == "answer_altered":
        got = ref
    else:
        raise ValueError(f"no mode {mode!r} for a retrieval cell")
    vals, idx = got.topk(k, dim=1)
    if mode == "answer_altered":
        idx[:, 0] = (idx[:, 0] + 1) % ids.shape[0]
        vals, order = got.gather(1, idx).sort(dim=1, descending=True)
        idx = idx.gather(1, order)
    return judge.topk(ref, vals, idx, k)


def train_readings(run: Run, dev, mode: str) -> dict:
    cfg, tr = run.config, run.traffic
    shapes = dict(tr, vocab_size=cfg["vocab_size"])
    data = traffic.corpus(run.seed, shapes, dev)
    ranks = int(tr.get("ranks", 1))
    batch = int(tr["batch"]) * ranks
    follow = int(tr["steps_per_dispatch"]) + 1
    ref = plain.train(cfg, cfg["solver"], run.seed, data["train"], batch,
                      follow, dev)
    kw = {"control": {"tf32": True}, "half_batch": {"keep": 2},
          "no_exchange": {"rows": int(tr["batch"])}}[mode]
    got = plain.train(cfg, cfg["solver"], run.seed, data["train"], batch,
                      follow, dev, **kw)
    norms = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in got["grads"].items()}
    return judge.training(got["losses"].tolist(), norms, got["params"], ref,
                          int(tr["check_losses"]))


def readings(run: Run, dev, mode: str) -> dict:
    if run.traffic["kind"] == "query":
        return query_readings(run, dev, mode)
    return train_readings(run, dev, mode)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True)
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
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
