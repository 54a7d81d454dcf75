"""Closed-loop load test for the HTTP retrieval service (twin of
``examples/serve_load.py``, over ``serve/server.py``).

Measures end-to-end requests/s and latency percentiles of a live
``QAServer`` under N concurrent clients, with micro-batching off vs on,
so the dispatch-coalescing win is a number rather than a claim.  The
reference has no serving daemon to compare against (its batch path is
``caffe test``, tools/caffe.cpp:229-296): the comparison here is the
server against itself.  Requests go to the server on 127.0.0.1.

    python -m mms_answer_selection_tpu_torch.examples.serve_load \\
        [--pool 262144] [--clients 16] [--requests 256] [--window-ms 5] \\
        [--rerank 0] [--json out.json]

On the card use the defaults (the int8 MaxSim kernel scores the pool); on
the CPU smoke-test with ``--pool 2048 --clients 4 --requests 32
--interpret``, which runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np


def run_load(base_url, queries, clients, k, rerank):
    """Each client thread POSTs its share of ``queries`` one at a time
    (closed loop).  Returns (wall_s, per-request latencies ms)."""
    lat_ms = []
    lock = threading.Lock()
    shares = np.array_split(np.arange(len(queries)), clients)

    def worker(idxs):
        mine = []
        for i in idxs:
            body = {"tokens": [int(t) for t in queries[i]], "k": k}
            if rerank:
                body["rerank"] = rerank
            req = urllib.request.Request(
                base_url + "/query", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                json.loads(r.read())
            mine.append((time.perf_counter() - t0) * 1e3)
        with lock:
            lat_ms.extend(mine)

    threads = [threading.Thread(target=worker, args=(s,)) for s in shares]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return wall, sorted(lat_ms)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", type=int, default=262_144)
    ap.add_argument("--vocab", type=int, default=30000)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rerank", type=int, default=0)
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--pool-dtype", default="int8",
                    choices=["int8", "bf16"])
    ap.add_argument("--interpret", action="store_true",
                    help="CPU smoke mode (the plain PyTorch versions)")
    ap.add_argument("--json", help="also write results to this path")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from ..models.mms_qa import V4, mms_qa_init
    from ..serve import QAServer, QueryEngine
    from ..utils.tree import tree_map

    device = "cpu" if args.interpret else None
    cfg = dataclasses.replace(V4, vocab_size=args.vocab)
    params, state = mms_qa_init(
        cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    params["sim"]["w"] = torch.as_tensor(
        rng.normal(size=tuple(params["sim"]["w"].shape)).astype(np.float32)
        * 0.1)
    pool_ids = rng.integers(0, cfg.vocab_size,
                            (args.pool, cfg.answer_len), dtype=np.int32)
    queries = rng.integers(0, cfg.vocab_size,
                           (args.requests, cfg.question_len),
                           dtype=np.int32)

    engine = QueryEngine(params, cfg, pool_dtype=args.pool_dtype,
                         device=device)
    engine.build_index(pool_ids)
    state = tree_map(lambda t: t.to(engine.device), state)

    results = {"pool": args.pool, "clients": args.clients,
               "requests": args.requests, "k": args.k,
               "rerank": args.rerank, "pool_dtype": args.pool_dtype}
    for label, window in [("unbatched", 0.0),
                          ("batched", args.window_ms)]:
        srv = QAServer(engine, state=state, port=0,
                       batch_window_ms=window).start()
        base = f"http://{srv.host}:{srv.port}"
        # warm up every batch shape outside the timed region
        run_load(base, queries[: min(args.clients * 2, args.requests)],
                 args.clients, args.k, args.rerank)
        wall, lat = run_load(base, queries, args.clients, args.k,
                             args.rerank)
        snap = srv.stats.snapshot()
        row = {"req_per_s": len(queries) / wall,
               "p50_ms": lat[len(lat) // 2],
               "p90_ms": lat[int(len(lat) * 0.9)],
               "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
               "device_dispatches": snap["device_dispatches"],
               "rows_per_dispatch": (snap["device_dispatch_rows"]
                                     / max(1, snap["device_dispatches"]))}
        results[label] = row
        print(json.dumps({label: {k: (round(v, 3)
                                      if isinstance(v, float) else v)
                                  for k, v in row.items()}}), flush=True)
        srv.close()
    if results.get("batched") and results.get("unbatched"):
        results["speedup"] = (results["batched"]["req_per_s"]
                              / results["unbatched"]["req_per_s"])
        print(json.dumps({"speedup": round(results["speedup"], 3)}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
