"""Retrieval throughput: ``QueryEngine.query`` in a closed loop with one
caller.

Set-up makes the serving weights, the candidate pool's ids and the query
batches on the card from the seed, builds the engine's index (the pool
embedded and packed in the mix's precision, chunk by chunk) and calls
``query`` ``warmup_calls`` times, so the first call's graph capture and
every kernel's first launch fall before the window.  The window then
calls ``query`` on the pre-drawn batches in turn, each call ended by the
fetch of its top-k to the host, until ``--seconds`` have passed:

    query_pairs_per_s = calls x batch x pool / (end of the last call -
                        start of the window)

After the window the engine is freed and the reference scores a sample
of the window's queries, drawn from the seed, against the whole pool in
the pool's precision (``reference/plain.py``); ``judge.topk`` compares
the returned lists with it.
"""

from __future__ import annotations

import gc
import time

import torch

from h100_bench import judge, port, traffic
from h100_bench.reference import plain
from h100_bench.trace import Tracer


def engine_for(run, params, ids, device):
    from mms_answer_selection_tpu_torch.serve.query_engine import QueryEngine

    tr = run.traffic
    engine = QueryEngine(params, port.model_config(run.config),
                         pool_dtype=tr["pool_dtype"],
                         chunk_size=int(tr["chunk_size"]), device=device)
    return engine.build_index(ids)


def call(engine, batch, k: int):
    """One ``query``, ended by the fetch of its top-k to the host."""
    with torch.profiler.record_function("bench.query_call"):
        vals, idx = engine.query(batch, k=k)
        return vals.cpu(), idx.cpu()


def window(run, engine, batches, k: int) -> list:
    """Calls until ``run.seconds`` have passed; returns [(batch index,
    scores, indices)] and fills the run's work and rate."""
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    tracer = Tracer() if run.trace else None
    launches = dict(sk.LAUNCH_COUNTS)
    if tracer:
        tracer.start()
    outs, call_s = [], []
    t0 = t = time.perf_counter()
    while t - t0 < run.seconds:
        b = len(outs) % batches.shape[0]
        vals, idx = call(engine, batches[b], k)
        now = time.perf_counter()
        call_s.append(now - t)
        t = now
        outs.append((b, vals, idx))
    window_s = t - t0
    if tracer:
        run.device_trace = tracer.stop()
    run.counters = {n: sk.LAUNCH_COUNTS[n] - c for n, c in launches.items()}
    nq, pool = batches.shape[1], engine.pool_size
    run.work = {"calls": len(outs), "batch": nq, "pool": pool,
                "window_s": window_s, "call_s": call_s,
                "pool_dtype": run.traffic["pool_dtype"]}
    run.attempted = len(outs) * nq
    run.e2e["query_pairs_per_s"] = len(outs) * nq * pool / window_s
    return outs


def reference_scores(run, params, ids, q_ids, dtype: str) -> torch.Tensor:
    """The reference's (S, pool) scores of the queries ``q_ids``."""
    with plain.precision(False), torch.no_grad():
        q_tok = plain.embed(params, q_ids)
        return plain.maxsim_scores(
            q_tok, lambda a, b: plain.embed(params, ids[a:b]),
            ids.shape[0], params["sim"]["w"], dtype,
            int(run.traffic["ref_block"]))


def check(run, params, ids, batches, outs, k: int) -> None:
    """The sampled queries' lists against the reference."""
    nq = batches.shape[1]
    picks = traffic.sample(run.seed, len(outs) * nq,
                           int(run.traffic["check_queries"]))
    rows = [(p // nq, p % nq) for p in picks]
    q_ids = torch.stack([batches[outs[c][0]][r] for c, r in rows])
    vals = torch.stack([outs[c][1][r] for c, r in rows])
    idx = torch.stack([outs[c][2][r] for c, r in rows])
    ref = reference_scores(run, params, ids, q_ids, run.traffic["pool_dtype"])
    readings = judge.topk(ref, vals, idx, k)
    for name, value in readings.items():
        run.compare(name, value, run.traffic["limits"])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def execute(run) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    measure(run, dev)


def measure(run, dev) -> None:
    """Set-up, the window and the check on ``dev`` (the tests drive it on
    the CPU at small sizes)."""
    run.device = dev
    cfg, tr = run.config, run.traffic
    shapes = dict(tr, vocab_size=cfg["vocab_size"])
    params = port.serving_weights(cfg, run.seed, dev)
    ids = traffic.candidates(run.seed, shapes, dev)
    batches = traffic.query_batches(run.seed, shapes, dev)
    k = int(tr["k"])
    sync(dev)
    run.mark("inputs made")
    engine = engine_for(run, params, ids, dev)
    sync(dev)
    run.mark("index built")
    for i in range(int(tr["warmup_calls"])):
        call(engine, batches[i % batches.shape[0]], k)
    sync(dev)
    run.setup_done()
    outs = window(run, engine, batches, k)
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, params, ids, batches, outs, k)
