"""int8 fidelity error analysis at scale (twin of
``examples/int8_error_analysis.py``).

Question: why does int8 top-10 agreement drift with pool size while
top-10-in-top-50 recall stays 1.0, and does it plateau or keep degrading
toward 10M?  Here the card's own kernels answer it: bf16 scores through
the bf16 MaxSim kernel, int8 through the int8 one.

Method (same synthetic family as bench.py's pool suite, everything drawn
from numpy ``default_rng(7)``):

1. **Per-pair quantization error** is pool-size independent by
   construction (each candidate quantizes alone): measured directly on a
   2,048-candidate subpool scored by both engines (full score vectors).
2. **Top-k score gaps** do shrink with pool size (order statistics: the
   upper tail crowds as N grows), measured from the bf16 engine's top-50
   score rows at each pool size.
3. Agreement@10 falls when |error_i - error_j| exceeds the rank-boundary
   gap; with gap_10(N) shrinking and sigma_err constant, agreement must
   fall with N: the drift is geometry, not a quantization bug.
4. **Serving guidance** comes from rank displacement: for every bf16
   top-10 candidate, its rank in the int8 ordering; the rerank shortlist
   S must exceed the worst displacement.  The artifact reports the
   displacement distribution per pool size and a fitted S(N) rule.

Writes ``docs/runs_torch/int8_error_analysis/summary.json`` (the JAX
package's artifact under ``docs/runs/`` stays as it is).  Run:

    python -m mms_answer_selection_tpu_torch.examples.int8_error_analysis

``error_analysis(pools, subpool=..., device="cpu")`` runs it at other pool
sizes, or on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "docs", "runs_torch", "int8_error_analysis")


def _tag(n: int) -> str:
    """262144 -> '262k', 1048576 -> '1m': the JAX artifact's key names."""
    return f"{round(n / 1e6)}m" if n >= 1e6 else f"{round(n / 1e3)}k"


def error_analysis(pools=(262144, 1048576), *, subpool: int = 2048,
                   device=None) -> dict:
    """The study at ``subpool`` (step 1) and each of two ``pools`` (steps
    2-4); returns the summary dict."""
    import torch

    from ..models.mms_qa import MMSQAConfig
    from ..serve import QueryEngine

    d, w1, w2, m, vocab = 50, 40, 40, 4, 50000
    nq, k, s_max = 64, 10, 512
    cfg = MMSQAConfig(vocab_size=vocab, embed_dim=d, question_len=w1,
                      answer_len=w2, sim_measures=m)
    rng = np.random.default_rng(7)
    embed_table = torch.as_tensor(
        rng.normal(size=(vocab, d)).astype(np.float32) * 0.3)
    w = torch.as_tensor(rng.normal(size=(m, d, d)).astype(np.float32)
                        * 0.05)
    params = {"embed": {"w": embed_table}, "sim": {"w": w}}
    queries = rng.integers(0, vocab, (nq, w1)).astype(np.int32)

    def build(mode, cand_ids, scan=True):
        return QueryEngine(params, cfg, pool_dtype=mode, scan_chunks=scan,
                           device=device).build_index(cand_ids)

    def top(eng, kk):
        v, i = eng.query(queries, k=kk)
        return v.cpu().numpy().astype(np.float64), i.cpu().numpy()

    def free():
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    out = {"n_queries": nq, "k": k, "s_max": s_max}
    t0 = time.time()

    # ---- 1. per-pair error distribution (pool-size independent)
    sub_ids = rng.integers(0, vocab, (subpool, w2)).astype(np.int32)
    v_bf, i_bf = top(build("bf16", sub_ids), subpool)
    v_i8, i_i8 = top(build("int8", sub_ids), subpool)
    # re-key by candidate index -> aligned per-pair scores
    bf_by_idx = np.empty_like(v_bf)
    i8_by_idx = np.empty_like(v_i8)
    for qi in range(nq):
        bf_by_idx[qi, i_bf[qi]] = v_bf[qi]
        i8_by_idx[qi, i_i8[qi]] = v_i8[qi]
    err = i8_by_idx - bf_by_idx
    out["per_pair_error"] = {
        "sigma": float(err.std()),
        "mean": float(err.mean()),
        "p99_abs": float(np.quantile(np.abs(err), 0.99)),
        "rel_sigma_vs_top_score": float(err.std()
                                        / np.abs(v_bf[:, 0]).mean()),
    }
    print(f"per-pair error: {out['per_pair_error']} "
          f"({time.time() - t0:.0f}s)", flush=True)
    free()

    # ---- 2-4. per pool size: gaps, agreement, displacement
    for pool in pools:
        tag = f"pool_{pool}"
        cand_ids = rng.integers(0, vocab, (pool, w2)).astype(np.int32)
        vb, ib = top(build("bf16", cand_ids, scan=pool <= 300_000), 50)
        free()
        vi, ii = top(build("int8", cand_ids), s_max)
        free()

        gaps10 = vb[:, 9] - vb[:, 10]
        gaps1 = vb[:, 0] - vb[:, 1]
        agree = np.mean([len(set(ib[q, :k]) & set(ii[q, :k])) / k
                         for q in range(nq)])
        # rank displacement of every bf16 top-10 candidate in the int8
        # ordering (s_max+1 when pushed beyond the measured window)
        disp = []
        for q in range(nq):
            pos = {c: r for r, c in enumerate(ii[q])}
            disp.extend(pos.get(c, s_max) + 1 for c in ib[q, :k])
        disp = np.asarray(disp)
        out[tag] = {
            "gap10_median": float(np.median(gaps10)),
            "gap10_p10": float(np.quantile(gaps10, 0.10)),
            "gap1_median": float(np.median(gaps1)),
            "top10_agreement": float(agree),
            "displacement_p50": float(np.quantile(disp, 0.50)),
            "displacement_p99": float(np.quantile(disp, 0.99)),
            "displacement_max": int(disp.max()),
            "recall10_in_s": {
                str(s): float(np.mean(disp <= s))
                for s in (10, 20, 50, 100, 200, s_max)},
        }
        print(f"{tag}: {out[tag]} ({time.time() - t0:.0f}s)", flush=True)

    # ---- fit: gap10(N) ~ c * N^-a from the two measured points, and the
    # shortlist rule S(N) from worst displacement scaling
    small, big = pools
    g_s = out[f"pool_{small}"]["gap10_median"]
    g_b = out[f"pool_{big}"]["gap10_median"]
    a = float(np.log(g_s / g_b) / np.log(big / small))
    out["gap_scaling_exponent"] = a
    d_s = out[f"pool_{small}"]["displacement_max"]
    d_b = out[f"pool_{big}"]["displacement_max"]
    b = float(np.log(max(d_b, 1) / max(d_s, 1))
              / np.log(big / small)) if d_s and d_b else 0.0
    out["displacement_scaling_exponent"] = b
    out["guidance"] = {
        "rule": "shortlist S(N) = max(50, 4 * worst_measured_disp * "
                "(N/1M)^b); recall@10 stays ~1.0 while the exact "
                "reranker owns the final order",
        f"S_{_tag(small)}": int(max(50, 4 * d_s)),
        f"S_{_tag(big)}": int(max(50, 4 * d_b)),
        f"S_{_tag(4 * big)}_pred": int(max(50, 4 * d_b * (4 ** b))),
        f"S_{_tag(10 * big)}_pred": int(max(50, 4 * d_b * (10 ** b))),
    }
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None, *, out_dir: str = OUT_DIR, device=None) -> dict:
    argparse.ArgumentParser().parse_args(argv)  # the script takes no flags
    from . import card_description

    out = error_analysis(device=device)
    out["card"] = card_description() if device != "cpu" else None
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
