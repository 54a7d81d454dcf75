"""Recipe-scale hermetic accuracy rehearsal (twin of
``examples/recipe_scale_rehearsal.py``).

TREC-QA and GloVe are not in the repository, so this run substitutes a
synthetic corpus with the real recipe's dimensions and a plantable signal,
then trains the published V4 recipe (do_trec_qa_clean.py:48-73
hyperparameters) for thousands of iterations on the card, through the
pair-map kernels:

- corpus: ~1,250 train questions x ~40 answers (~50k pairs, matching
  train-all's 53,417), dev ~65 q / ~1.1k pairs, test ~68 q / ~1.5k pairs,
  vocab ~20k, 40x40 tokens
- signal: topic-structured embeddings only -- literal question-token
  overlap is injected into positives and negatives at the same rate, so
  the overlap features carry no label signal and MAP starts at chance;
  learning must come through the zero-initialized bilinear metric
- asserts: dev MAP rises well above the chance floor; the in-graph MAP/MRR
  (torch) == numpy MAP/MRR == in-process trec_eval on the final test
  scores (the parity the reference gets by shelling out to trec_eval-8.0,
  do_trec_qa_clean.py:650)

Writes docs/runs-style artifacts (summary.json, history.json, truth/result,
curve.png where matplotlib is installed) under --out.  ``--cpu`` runs the
plain PyTorch versions on the CPU; otherwise the run needs a card.
``--fused-steps`` is ``Trainer.fit``'s ``steps_per_dispatch``: on the card
each chunk of up to K steps is one CUDA graph replay (each chunk length
captured once), as the JAX package's chunk is one fused dispatch, and so
is each split's eval (``eval_dispatch`` in ``summary.json``); on the CPU
the chunk's steps and the evals run eagerly.

    python -m mms_answer_selection_tpu_torch.examples.recipe_scale_rehearsal \\
        --out docs/runs_torch/recipe_full_budget_graphs --max-iter 40001 --hard \\
        --early-stop-patience 0 --fused-steps 50 --snapshot-interval 1000
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "recipe_scale_v4"))
    ap.add_argument("--train-q", type=int, default=1250)
    ap.add_argument("--dev-q", type=int, default=65)
    ap.add_argument("--test-q", type=int, default=68)
    ap.add_argument("--vocab-words", type=int, default=22500)
    ap.add_argument("--topics", type=int, default=250)
    ap.add_argument("--max-iter", type=int, default=3001)
    ap.add_argument("--test-interval", type=int, default=100)
    ap.add_argument("--snapshot-interval", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    ap.add_argument("--fused-steps", type=int, default=1,
                    help="steps per dispatch (Trainer.fit "
                         "steps_per_dispatch)")
    ap.add_argument("--hard", action="store_true",
                    help="inject intrinsic Bayes error (weak positives + "
                         "on-topic distractor negatives) so MAP converges "
                         "to an interior asymptote like real data")
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--min-gain", type=float, default=0.25,
                    help="required best-dev-MAP rise over the step-0 "
                         "chance floor (0 for smoke runs)")
    ap.add_argument("--model", default="v4", choices=["v4", "v4_wide"],
                    help="v4_wide = BASELINE configs[1]: GloVe-300d + "
                         "wider conv encoder (64/128 ch)")
    ap.add_argument("--dim", type=int, default=None,
                    help="w2v dimension (default: the model's embed_dim)")
    ap.add_argument("--format", default="trec", choices=["trec", "wikiqa"],
                    help="wikiqa = BASELINE configs[2]: the synthetic "
                         "corpus is serialized as WikiQA TSVs and "
                         "ingested through data.wikiqa.prepare_wikiqa "
                         "(sparse positives, many all-negative "
                         "questions)")
    ap.add_argument("--early-stop-patience", type=int, default=5,
                    help="epochs without dev-MAP improvement before "
                         "stopping (do_trec_qa_clean.py's wait_patience "
                         "5); 0 disables — the full-budget run walks all "
                         "max_iter steps")
    return ap.parse_args(argv)


def _to_tsv(xml):
    """A TREC-QA XML corpus as WikiQA's TSV."""
    from ..data.trec_qa import parse_trec_xml

    qids, qs, ans, labels = parse_trec_xml(xml)
    rows = ["QuestionID\tQuestion\tDocumentID\tDocumentTitle"
            "\tSentenceID\tSentence\tLabel"]
    for i, (qid, q, a, lab) in enumerate(zip(qids, qs, ans, labels)):
        rows.append(f"Q{qid}\t{' '.join(q)}\tD{qid}\ttitle"
                    f"\tD{qid}-{i}\t{' '.join(a)}\t{lab}")
    return "\n".join(rows) + "\n"


def build_corpus(args, dim: int):
    """The recipe's splits and vocabulary info, as the JAX script builds
    them from the same flags: (splits, info)."""
    from ..data import prepare_trec_qa, synthetic_split, synthetic_world
    from ..data.wikiqa import prepare_wikiqa

    world = synthetic_world(vocab_words=args.vocab_words,
                            n_topics=args.topics, dim=dim, seed=args.seed)
    # distractor negatives are more on-topic (0.30) than weak positives
    # (0.12): the Bayes-optimal ranker must misorder those pairs, so MAP
    # converges to an interior asymptote (like real data) by construction
    hard = dict(weak_pos_frac=0.35, weak_topic_rate=0.12,
                distractor_frac=0.30, distractor_topic_rate=0.30) \
        if args.hard else {}
    # WikiQA's hallmark statistics: sparse positives (~12-15%) and about
    # half the questions with no correct answer at all
    wiki = dict(pos_frac=0.15, all_neg_frac=0.5) \
        if args.format == "wikiqa" else {}

    def split(n_q, lo, hi, seed):
        if args.format == "wikiqa":
            lo, hi = 8, 12              # WikiQA: ~10 candidates/question
        return synthetic_split(world, n_q, lo, hi, seed=seed, **hard,
                               **wiki)

    train_xml = split(args.train_q, 30, 50, 101)
    dev_xml = split(args.dev_q, 12, 24, 202)
    test_xml = split(args.test_q, 15, 29, 303)
    if args.format == "wikiqa":
        # the corpus as WikiQA TSVs through the WikiQA loader: the
        # configs[2] pipeline end to end
        return prepare_wikiqa(_to_tsv(train_xml), _to_tsv(dev_xml),
                              _to_tsv(test_xml), world["w2v"])
    return prepare_trec_qa(train_xml, dev_xml, test_xml, world["w2v"])


def _plot(out, hist, chance, record_interval) -> None:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 4))
        ax0.plot(np.arange(len(hist["train_loss"])) * record_interval,
                 hist["train_loss"], lw=0.8)
        ax0.set(title="train loss", xlabel="iteration")
        ax1.plot(hist["steps"], hist["dev_map"], label="dev MAP")
        if hist["test_map"]:
            ax1.plot(hist["steps"], hist["test_map"], label="test MAP")
        ax1.axhline(chance, color="gray", ls="--", lw=0.8, label="chance")
        ax1.set(title="MAP", xlabel="iteration")
        ax1.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out, "curve.png"), dpi=110)
        plt.close(fig)
    except Exception as e:  # matplotlib is optional (the H100 host lacks it)
        print(f"curve.png skipped: {e}")


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ..metrics import (format_trec_table, mean_average_precision,
                           mean_reciprocal_rank, trec_eval, write_trec_files)
    from ..models.mms_qa import V4, V4_WIDE
    from ..training import SolverConfig, Trainer, TrainerConfig
    from . import card_description

    device = "cpu" if args.cpu else None
    base_cfg = {"v4": V4, "v4_wide": V4_WIDE}[args.model]
    dim = args.dim or base_cfg.embed_dim
    t0 = time.time()
    splits, info = build_corpus(args, dim)
    sizes = {k: int(len(v["label"])) for k, v in splits.items()}
    print(f"corpus: {sizes}, vocab_size={info['vocab_size']} "
          f"({time.time() - t0:.0f}s)", flush=True)

    model_cfg = dataclasses.replace(base_cfg, vocab_size=info["vocab_size"],
                                    embed_dim=dim)
    trainer_cfg = TrainerConfig(
        solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                            momentum=0.95, delta=5e-7, weight_decay=5e-4),
        max_iter=args.max_iter, batch_size=50,
        test_interval=args.test_interval,
        snapshot_interval=args.snapshot_interval,
        early_stop_patience=(args.early_stop_patience
                             or args.max_iter),  # 0 = never fires
        seed=args.seed,
        snapshot_dir=os.path.join(args.out, "models"))
    t_fit = time.time()
    trainer = Trainer(model_cfg, trainer_cfg, device=device)
    hist = trainer.fit(splits["train"], splits["dev"],
                       test_data=splits["test"],
                       pretrained=info["pretrained"], log_every=100,
                       steps_per_dispatch=args.fused_steps)
    fit_s = time.time() - t_fit
    # the evals as dispatched (``evaluate`` below takes its own copies)
    evals = {"graph_replays": trainer.evals.replays,
             "captures": [{k: c[k] for k in ("capture_s", "pool_bytes")}
                          for c in trainer.evals.stats()]}
    chance = hist["dev_map"][0]
    print(f"dev MAP: chance(step0)={chance:.4f} "
          f"best={hist['best_dev_map']:.4f} @ {hist['best_step']} "
          f"({time.time() - t0:.0f}s)", flush=True)

    # ---- final-score metric parity: in-graph torch == numpy == trec_eval
    res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
    scores = np.asarray(res["prob"][:, 1], np.float64)
    labels = splits["test"]["label"]
    groups = splits["test"]["group"]
    np_map = mean_average_precision(scores, labels, groups)
    np_mrr = mean_reciprocal_rank(scores, labels, groups)
    ev = trec_eval(scores=scores, labels=labels, groups=groups)
    torch_map, torch_mrr = float(res["map"]), float(res["mrr"])
    assert abs(torch_map - np_map) < 1e-5, (torch_map, np_map)
    assert abs(torch_mrr - np_mrr) < 1e-5, (torch_mrr, np_mrr)
    assert abs(ev["map"] - np_map) < 1e-9, (ev["map"], np_map)
    assert abs(ev["recip_rank"] - np_mrr) < 1e-9, (ev["recip_rank"], np_mrr)
    assert hist["best_dev_map"] > chance + args.min_gain, \
        f"no learning: chance {chance:.4f} -> best {hist['best_dev_map']:.4f}"
    print("parity OK: in-graph == numpy == trec_eval", flush=True)
    print(format_trec_table(ev), flush=True)

    # ---- artifacts
    os.makedirs(args.out, exist_ok=True)
    write_trec_files(os.path.join(args.out, "truth"),
                     os.path.join(args.out, "result"),
                     scores, labels, groups)
    curves = {k: v for k, v in hist.items()
              if k not in ("params", "state")}
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(curves, f)
    summary = {
        "model": args.model, "format": args.format, "embed_dim": dim,
        "corpus": sizes, "vocab_size": int(info["vocab_size"]),
        "chance_dev_map_step0": float(chance),
        "best_dev_map": float(hist["best_dev_map"]),
        "best_step": int(hist["best_step"]),
        "test_map": float(np_map), "test_mrr": float(np_mrr),
        "test_trec_eval": {k: v for k, v in ev.items()
                           if not isinstance(v, dict)},
        "max_iter": args.max_iter,
        "early_stop_patience": args.early_stop_patience,
        "last_eval_step": int(hist["steps"][-1]) if hist.get("steps")
        else 0,
        "backend": trainer.device.type,
        "card": None if args.cpu else card_description(),
        "fit_s": round(fit_s, 1),
        "wall_s": round(time.time() - t0, 1),
        # the chunks as dispatched: graph replays and each length's capture
        "dispatch": {"graph_replays": trainer.runner.replays,
                     "captures": [{k: c[k] for k in ("k", "capture_s",
                                                     "pool_bytes")}
                                  for c in trainer.runner.stats()]},
        "eval_dispatch": evals,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    _plot(args.out, hist, chance, trainer_cfg.train_loss_record_interval)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
