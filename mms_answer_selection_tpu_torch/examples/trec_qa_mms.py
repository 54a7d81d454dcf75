"""End-to-end TREC-QA MMS recipe as a library script (twin of
``examples/trec_qa_mms.py``).

The programmatic equivalent of the reference's
examples/trec_qa_w2v_mms/do_trec_qa_clean.py driver (and of the CLI's
prep+train+eval), showing the whole pipeline through the Python API on
the card: training through the pair-map kernels, then retrieval over the
test answers through the bf16 MaxSim kernel:

    python -m mms_answer_selection_tpu_torch.examples.trec_qa_mms \\
        --train-xml train-all.xml --dev-xml dev.xml --test-xml test.xml \\
        --glove glove.6B.50d.txt --out runs/v4

Without arguments it runs hermetically on a synthetic corpus (smoke mode).
``main(argv, device="cpu")`` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-xml")
    ap.add_argument("--dev-xml")
    ap.add_argument("--test-xml")
    ap.add_argument("--glove")
    ap.add_argument("--dim", type=int, default=50)
    ap.add_argument("--out", default="runs/example")
    ap.add_argument("--max-iter", type=int, default=40001)
    return ap.parse_args(argv)


def main(argv=None, *, device=None) -> dict:
    args = parse_args(argv)

    from ..data import prepare_trec_qa, synthetic_corpus
    from ..metrics import trec_eval
    from ..models.mms_qa import V4, ConvBlock, MMSQAConfig
    from ..ops.embed import load_pretrained_vectors
    from ..serve import QueryEngine
    from ..training import SolverConfig, Trainer, TrainerConfig
    from ..utils.history import summarize_model

    if args.train_xml:
        words, vecs = load_pretrained_vectors(args.glove, args.dim)
        w2v = dict(zip(words, vecs))
        splits, info = prepare_trec_qa(args.train_xml, args.dev_xml,
                                       args.test_xml, w2v)
        model_cfg = dataclasses.replace(V4, vocab_size=info["vocab_size"],
                                        embed_dim=args.dim)
        max_iter = args.max_iter
    else:  # hermetic smoke mode
        xml, w2v = synthetic_corpus(n_questions=12, answers_per_q=6, seed=22)
        splits, info = prepare_trec_qa(xml, xml, xml, w2v)
        for s in splits.values():  # shrink to 12 tokens for speed
            s["question"] = s["question"][:, 14:26]
            s["answer"] = s["answer"][:, 14:26]
        model_cfg = MMSQAConfig(
            vocab_size=info["vocab_size"], embed_dim=50,
            question_len=12, answer_len=12, sim_measures=2,
            blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                    ConvBlock(3, 3, 8, "ave", 3, 1)),
            fc1_dim=8)
        max_iter = 200

    print(summarize_model(model_cfg))

    # the published recipe's solver (BASELINE.md): AdaDelta, base_lr 1.0,
    # rho 0.95, delta 5e-7, weight decay 5e-4, fixed LR, seed 22
    trainer_cfg = TrainerConfig(
        solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                            momentum=0.95, delta=5e-7, weight_decay=5e-4),
        max_iter=max_iter, batch_size=50 if args.train_xml else 15,
        test_interval=100 if args.train_xml else 20,
        early_stop_patience=5, seed=22,
        snapshot_dir=os.path.join(args.out, "models"))
    trainer = Trainer(model_cfg, trainer_cfg, device=device)
    hist = trainer.fit(splits["train"], splits["dev"],
                       test_data=splits["test"],
                       pretrained=info["pretrained"], log_every=100)
    print(f"best dev MAP {hist['best_dev_map']:.4f} @ {hist['best_step']}")

    res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
    ev = trec_eval(scores=res["prob"][:, 1], labels=splits["test"]["label"],
                   groups=splits["test"]["group"])
    result = {"test_map": ev.get("map"), "test_mrr": ev.get("recip_rank")}
    print(json.dumps(result))

    # retrieval over the test answers with the learned metric (the params
    # are tensors on the trainer's device already)
    engine = QueryEngine(hist["params"], model_cfg, device=trainer.device)
    engine.build_index(splits["test"]["answer"])
    vals, idx = engine.query(splits["test"]["question"][:3], k=5)
    print("retrieval top-5 for first 3 queries:", idx.tolist())
    return {**result, "best_dev_map": float(hist["best_dev_map"]),
            "best_step": int(hist["best_step"]),
            "retrieval_top5": idx.tolist()}


if __name__ == "__main__":
    main()
