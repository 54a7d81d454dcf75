"""BASELINE configs[3]: brute-force learned-metric retrieval over a 1M
synthetic candidate pool (twin of ``examples/retrieval_1m.py``).

One card holds the int8 pool and scores it in chunks through the int8
MaxSim kernel.  ``--mesh`` splits the pool over a ``parallel.make_mesh``
mesh of the process group's ranks (one card each; a lone process makes a
one-rank group), with a per-rank top-k merged across ranks.  With
``--ivf-clusters`` / ``--coarse-shortlist`` the pool is bf16 and IVF's
coarse stage and probes run the bf16 MaxSim kernel.

    python -m mms_answer_selection_tpu_torch.examples.retrieval_1m \\
        [--pool 1048576] [--queries 128]

``main(argv, device="cpu")`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pool", type=int, default=1_048_576)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=30000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the pool over all ranks of the process "
                         "group, one card each")
    ap.add_argument("--ivf-clusters", type=int, default=0,
                    help="also time the IVF approximate path with this "
                         "many clusters (switches the pool to bf16)")
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--coarse-shortlist", type=int, default=0,
                    help="also time the flat coarse-shortlist path "
                         "with this shortlist size")
    ap.add_argument("--coarse-tokens", type=int, default=8,
                    help="token centroids per candidate for the coarse "
                         "stage (1 = cheap mean-vector matmul; 8 = "
                         "mini-pool kernel, near-exact recall)")
    return ap.parse_args(argv)


def _sync_first(vals) -> None:
    """Read one score back: the host waits for the device's work."""
    float(vals[0, 0])


def _sync(device) -> None:
    """Wait for the card's queued work (a build returns before it ends)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, device=None) -> dict:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..models.mms_qa import V4, mms_qa_init
    from ..serve import QueryEngine, ivf_recall

    dev = resolve_device(device)
    cfg = dataclasses.replace(V4, vocab_size=args.vocab)
    params, _ = mms_qa_init(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    rng = np.random.default_rng(0)
    # a trained metric would come from a checkpoint; synthetic here
    params["sim"]["w"] = torch.as_tensor(
        rng.normal(size=(cfg.sim_measures, cfg.embed_dim,
                         cfg.embed_dim)).astype(np.float32) * 0.05,
        device=dev)

    mesh, own_group = None, False
    if args.mesh:
        from ..parallel.mesh import make_mesh
        own_group = not dist.is_initialized()
        mesh = make_mesh(devices=dev.type)

    cand_ids = rng.integers(0, args.vocab, (args.pool, cfg.answer_len),
                            dtype=np.int32)
    pool_dtype = "int8"
    if args.ivf_clusters or args.coarse_shortlist:
        pool_dtype = "bf16"  # the JAX script's IVF pools are bf16
    engine = QueryEngine(params, cfg, mesh=mesh, pool_dtype=pool_dtype,
                         device=None if mesh is not None else dev)
    t0 = time.perf_counter()
    engine.build_index(cand_ids)
    _sync(engine.device)
    index_s = time.perf_counter() - t0
    print(f"indexed {args.pool:,} candidates in {index_s:.1f}s")

    q_ids = torch.as_tensor(rng.integers(0, args.vocab,
                                         (args.queries, cfg.question_len)),
                            dtype=torch.int32, device=engine.device)
    vals, idx = engine.query(q_ids, k=args.k)   # warm-up
    _sync_first(vals)
    t0 = time.perf_counter()
    vals, idx = engine.query(q_ids, k=args.k)
    _sync_first(vals)
    dt = time.perf_counter() - t0
    pairs = args.queries * args.pool
    print(f"{args.queries} queries x {args.pool:,} candidates: "
          f"{pairs / dt / 1e6:.1f}M pairs/s ({dt * 1e3:.1f} ms)")
    top0 = list(zip(idx[0].cpu().tolist(),
                    np.round(vals[0].cpu().numpy(), 3).tolist()))
    print("top-k of query 0:", top0)
    out = {"pool": args.pool, "queries": args.queries,
           "pool_dtype": pool_dtype, "device": engine.device.type,
           "index_s": index_s, "query_ms": dt * 1e3,
           "pairs_per_s": pairs / dt, "top_k_query0": top0}

    if args.ivf_clusters or args.coarse_shortlist:
        # the approximate single-query path (serve/ivf.py): the coarse
        # stage routes, the exact kernel scores only the probed set
        t0 = time.perf_counter()
        ivf = engine.build_ivf(n_clusters=args.ivf_clusters or 1024,
                               coarse_tokens=args.coarse_tokens)
        _sync(engine.device)
        out["ivf_build_s"] = time.perf_counter() - t0
        print(f"ivf built in {out['ivf_build_s']:.1f}s "
              f"(bucket={ivf.bucket}, spilled={ivf.spilled}, "
              f"T={args.coarse_tokens})")
        one_q = q_ids[:1]
        modes = []
        if args.ivf_clusters:
            modes.append(("ivf", {"nprobe": args.nprobe}))
        if args.coarse_shortlist:
            modes.append(("coarse", {"shortlist": args.coarse_shortlist}))
        for name, kw in modes:
            qfn = (engine.query_ivf if name == "ivf"
                   else ivf.query_coarse)
            v, _ = qfn(one_q, k=args.k, **kw)      # warm-up
            _sync_first(v)
            t0 = time.perf_counter()
            v, _ = qfn(one_q, k=args.k, **kw)
            _sync_first(v)
            ms = (time.perf_counter() - t0) * 1e3
            r = ivf_recall(engine, q_ids[:16], k=args.k, method=name, **kw)
            print(f"{name} 1-query p50 ~{ms:.1f} ms, recall@{args.k} "
                  f"(16q) = {r:.3f}  [{kw}]")
            out[name] = {"ms": ms, f"recall@{args.k}": r, **kw}
    if own_group:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
