"""trec_eval-compatible scoring harness (a copy of the JAX package's
``metrics/trec_eval.py``, which is numpy only).

The reference's published MAP/MRR come from shelling out to the external
``trec_eval-8.0`` C binary over two text files written by the QA script
(do_trec_qa_clean.py:638-650).  This module reproduces both sides in-process:

* ``write_trec_files`` writes byte-compatible ``truth`` (qrels) and
  ``result`` (run) files, including the QA script's filtering of groups that
  are all-positive or all-negative (do_trec_qa_clean.py:640,646) and its
  ``groupid+1 0 idx ...`` field layout.
* ``trec_eval`` computes the FULL measure set trec_eval-8.0 reports (the
  README.md:20-49 table): num_q/num_ret/num_rel/num_rel_ret, MAP, gm_ap
  (geometric-mean AP, log floor 1e-5), R-prec, bpref (judged-nonrel-above
  penalty over min(R, N), counts capped at R), recip_rank (MRR),
  interpolated precision at 11 recall points, and P@k.  Ranking follows
  trec_eval's convention: sort by similarity descending, ties broken by
  document id *descending* (trec_eval-8.0 trvec_teval.c ranking rule).

Having both lets tests assert that the on-device metrics, the numpy
metrics, and the trec_eval-convention scores agree on tie-free data, and
makes the divergence on ties explicit instead of accidental.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

P_AT_K = (5, 10, 15, 20, 30, 100, 200, 500, 1000)
RECALL_POINTS = tuple(i / 10.0 for i in range(11))


def filter_effective_groups(scores, labels, groups):
    """Drop samples of groups that are all-positive or all-negative,
    mirroring the QA script's ``check`` filter (do_trec_qa_clean.py:640)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    groups = np.asarray(groups).astype(np.int64)
    keep = np.zeros(len(scores), dtype=bool)
    for g in np.unique(groups):
        sel = groups == g
        s = labels[sel].sum()
        if 0 < s < sel.sum():
            keep |= sel
    return scores[keep], labels[keep], groups[keep]


def write_trec_files(truth_path, result_path, scores, labels, groups,
                     *, run_tag: str = "glove"):
    """Write qrels + run files in the QA script's exact format."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    groups = np.asarray(groups).astype(np.int64)
    by_group: dict[int, list[int]] = defaultdict(list)
    for idx, g in enumerate(groups):
        by_group[int(g)].append(idx)
    with open(truth_path, "w") as ft, open(result_path, "w") as fr:
        for g, idxs in by_group.items():
            total = sum(int(labels[i]) for i in idxs)
            if not (0 < total < len(idxs)):
                continue
            for local, i in enumerate(idxs):
                ft.write(f"{g + 1} 0 {local} {int(labels[i])} \n")
                fr.write(f"{g + 1} 0 {local} 1 {scores[i]} {run_tag} \n")


def _parse_qrels(path):
    rel: dict[str, dict[str, int]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _iter, doc, judgment = parts[0], parts[1], parts[2], parts[3]
            rel[qid][doc] = int(judgment)
    return rel


def _parse_run(path):
    run: dict[str, list[tuple[str, float]]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, doc, sim = parts[0], parts[2], float(parts[4])
            run[qid].append((doc, sim))
    return run


def trec_eval(truth_path=None, result_path=None, *, scores=None, labels=None,
              groups=None):
    """Compute trec_eval-8.0 headline measures.

    Accepts either file paths (as the external binary does) or in-memory
    arrays (which are routed through the same effective-group filter the
    file writer applies).
    """
    if truth_path is not None:
        qrels = _parse_qrels(truth_path)
        run = _parse_run(result_path)
    else:
        s, l, g = filter_effective_groups(scores, labels, groups)
        qrels, run = defaultdict(dict), defaultdict(list)
        by_group: dict[int, int] = defaultdict(int)
        for score, lab, grp in zip(s, l, g):
            local = by_group[int(grp)]
            by_group[int(grp)] += 1
            qid = str(int(grp) + 1)
            qrels[qid][str(local)] = int(lab)
            run[qid].append((str(local), float(score)))

    num_q = 0
    num_ret = num_rel = num_rel_ret = 0
    sum_ap = sum_rr = sum_rprec = sum_bpref = sum_log_ap = 0.0
    sum_p_at = {k: 0.0 for k in P_AT_K}
    sum_iprec = {r: 0.0 for r in RECALL_POINTS}

    for qid, docs in run.items():
        judged = qrels.get(qid, {})
        n_rel = sum(1 for v in judged.values() if v > 0)
        if n_rel == 0:
            continue  # trec_eval skips queries with no relevant docs
        n_nonrel = sum(1 for v in judged.values() if v <= 0)
        num_q += 1
        num_ret += len(docs)
        num_rel += n_rel
        # trec_eval ranking: sim descending, ties by docno descending
        # trec_eval-8.0 sorts sim descending with ties broken by docno
        # STRING comparison descending (strcmp in its sort; '9' beats
        # '10'): two stable passes — docno desc, then sim desc — give
        # exactly that, for arbitrary (mixed numeric/alpha) docnos
        ranked = sorted(docs, key=lambda d: d[0], reverse=True)
        ranked = sorted(ranked, key=lambda d: -d[1])
        rels = [1 if judged.get(doc, 0) > 0 else 0 for doc, _ in ranked]
        # only judged docs participate in bpref (unjudged are invisible)
        judged_flags = [judged.get(doc) is not None for doc, _ in ranked]
        hits = 0
        ap = 0.0
        rr = 0.0
        bpref = 0.0
        nonrel_so_far = 0
        prec_at_recall = []
        for pos, (r, is_judged) in enumerate(zip(rels, judged_flags),
                                             start=1):
            if r:
                hits += 1
                ap += hits / pos
                if rr == 0.0:
                    rr = 1.0 / pos
                prec_at_recall.append((hits / n_rel, hits / pos))
                # bpref (trec_eval-8.0 m_bpref): penalty is the count of
                # judged-nonrelevant docs ranked above, capped at R, over
                # min(R, N)
                denom = min(n_rel, n_nonrel)
                if nonrel_so_far and denom:
                    bpref += 1.0 - min(nonrel_so_far, n_rel) / denom
                else:
                    bpref += 1.0
            elif is_judged:
                nonrel_so_far += 1
        num_rel_ret += hits
        sum_ap += ap / n_rel
        # gm_ap (trec_eval-8.0 geometric-mean MAP): logs of per-query AP
        # floored at MIN_GEO_MEAN = 1e-5
        sum_log_ap += math.log(max(ap / n_rel, 1e-5))
        sum_bpref += bpref / n_rel
        sum_rr += rr
        sum_rprec += sum(rels[:n_rel]) / n_rel
        for k in P_AT_K:
            sum_p_at[k] += sum(rels[:k]) / k
        # 11-point interpolated precision: max precision at recall >= r
        for r in RECALL_POINTS:
            best = 0.0
            for rec, prec in prec_at_recall:
                if rec >= r - 1e-12:
                    best = max(best, prec)
            sum_iprec[r] += best

    if num_q == 0:
        # every group degenerate: the full measure set, zeroed, so
        # callers indexing ev["map"] report 0 instead of KeyError
        out = {"num_q": 0, "num_ret": num_ret, "num_rel": num_rel,
               "num_rel_ret": num_rel_ret, "map": 0.0, "gm_ap": 0.0,
               "R-prec": 0.0, "bpref": 0.0, "recip_rank": 0.0}
        for k in P_AT_K:
            out[f"P_{k}"] = 0.0
        for r in RECALL_POINTS:
            out[f"ircl_prn.{r:.2f}"] = 0.0
        return out
    out = {
        "num_q": num_q,
        "num_ret": num_ret,
        "num_rel": num_rel,
        "num_rel_ret": num_rel_ret,
        "map": sum_ap / num_q,
        "gm_ap": float(np.exp(sum_log_ap / num_q)),
        "R-prec": sum_rprec / num_q,
        "bpref": sum_bpref / num_q,
        "recip_rank": sum_rr / num_q,
    }
    for k in P_AT_K:
        out[f"P_{k}"] = sum_p_at[k] / num_q
    for r in RECALL_POINTS:
        out[f"ircl_prn.{r:.2f}"] = sum_iprec[r] / num_q
    return out


def format_trec_table(results: dict) -> str:
    """Render results in trec_eval-8.0's stdout shape (the README.md:20-49
    table): `measure <tab> all <tab> value`, counts as ints, measures to 4
    decimals, in trec_eval's print order."""
    order = (["num_q", "num_ret", "num_rel", "num_rel_ret", "map", "gm_ap",
              "R-prec", "bpref", "recip_rank"]
             + [f"ircl_prn.{r:.2f}" for r in RECALL_POINTS]
             + [f"P_{k}" for k in P_AT_K])
    lines = []
    for key in order:
        if key not in results:
            continue
        label = f"P{key[2:]}" if key.startswith("P_") else key
        val = results[key]
        sval = str(int(val)) if key.startswith("num_") else f"{val:.4f}"
        lines.append(f"{label:<15}\tall\t{sval}")
    return "\n".join(lines)


