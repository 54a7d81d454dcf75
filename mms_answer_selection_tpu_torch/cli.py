"""The command-line tool of the port (counterpart of ``cli.py``): the
path every user takes, data prep, training with early stopping and
snapshots, ``trec_eval`` scoring and the retrieval service.

    python -m mms_answer_selection_tpu_torch.cli prep  --train-xml ... --glove ... --mmsp
    python -m mms_answer_selection_tpu_torch.cli train --data DIR --exp DIR [--stream] [--resume]
    python -m mms_answer_selection_tpu_torch.cli eval  --data DIR --exp DIR
    python -m mms_answer_selection_tpu_torch.cli serve --data DIR --exp DIR --int8 --index pool.npz --listen 0

and the tools beside it: ``extract`` (embeddings and probabilities of a
split), ``saliency`` (per-token |dLoss/dEmbedding|), ``summarize`` (the
model's layer table, a history as CSV), ``parse_log`` (a training log as
CSV), ``reproduce`` (the published recipe from the raw inputs, held to
the published MAP/MRR), ``image_mean`` (a mean-file BlobProto) and
``device_query``.  The reference's own workflow runs through ``solve``
(``caffe train --solver=...``: any net prototxt through GraphSolver, with
``.caffemodel`` / ``.solverstate`` snapshots) and ``nettest`` (``caffe
test``); ``train`` also takes a reference ``--solver-prototxt`` /
``--net-prototxt`` and ``.caffemodel`` / ``.solverstate`` files for
``--weights`` / ``--resume``.  The reference's tools around its
databases and pycaffe: ``convert`` (checkpoints <-> ``.caffemodel``),
``upgrade`` (legacy prototxts and binary nets), ``convert_imageset`` (an
image list -> LMDB / LevelDB / HDF5), ``extract_features``, ``classify``,
``detect`` and ``draw``.  ``time`` is ``caffe time`` on the card
(per-stage forward and backward, whole steps, any net prototxt, or the
serving lifecycle), ``plot`` draws learning curves from training logs,
``export`` freezes the eval forward and the weights into one
``torch.export`` artifact (``deploy.py``), and ``matbridge`` serves the
matcaffe command surface to the MATLAB client.  ``train`` and ``solve``
take ``--mesh-dp N``: data parallelism over N processes (one device each),
launched by ``torchrun`` or any launcher that sets ``MASTER_ADDR`` /
``WORLD_SIZE`` / ``RANK``.

The commands that run a model take ``--device`` (default ``cuda``, which
raises where no card is present; ``cpu`` runs the plain PyTorch paths).
Artifacts are the JAX package's: ``config.json`` (the same text),
``<exp>/models/qa_iter_<N>`` snapshots, ``best_iter_<N>``, ``truth`` /
``result``, ``history.json``, ``features_<split>.npz``, ``saliency.npz``;
the prepped data dir is the same set of ``.npz`` files and
``train.mmsp``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys

import numpy as np

log = logging.getLogger("mms_tpu_torch.cli")

# the last QAServer ``serve --listen`` started: an embedding process (or a
# test) stops it through this hook instead of signalling
_LAST_SERVER = None


# --------------------------------------------------------------------- prep
def cmd_prep(args):
    from .data import prepare_trec_qa, prepare_wikiqa, save_dataset
    from .ops.embed import load_pretrained_vectors

    words, vecs = load_pretrained_vectors(args.glove, args.dim)
    w2v = {w: v for w, v in zip(words, vecs)}
    log.info("loaded %d pretrained vectors", len(w2v))
    prepare = prepare_wikiqa if args.format == "wikiqa" else prepare_trec_qa
    splits, info = prepare(args.train_xml, args.dev_xml, args.test_xml, w2v,
                           q_len=args.q_len, a_len=args.a_len)
    os.makedirs(args.out, exist_ok=True)
    for name, split in splits.items():
        save_dataset(os.path.join(args.out, f"{name}.npz"), split)
        log.info("%s: %d pairs", name, len(split["label"]))
    np.savez_compressed(
        os.path.join(args.out, "vocab.npz"),
        pretrained=info["pretrained"],
        words=np.asarray(list(info["vocab"].keys())),
    )
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({"vocab_size": info["vocab_size"],
                   "unknown_idx": info["unknown_idx"],
                   "pad_idx": info["pad_idx"],
                   "dim": args.dim, "q_len": args.q_len,
                   "a_len": args.a_len}, f)
    if args.hdf5:
        from .data.hdf5_compat import save_hdf5_chunks
        for name, split in splits.items():
            save_hdf5_chunks(os.path.join(args.out, f"{name}_h5"), name,
                             split)
        log.info("wrote reference-compatible HDF5 chunks")
    if args.mmsp:
        from .native import write_mmsp
        write_mmsp(os.path.join(args.out, "train.mmsp"), splits["train"])
        log.info("wrote packed train.mmsp (train --stream input)")
    print(f"wrote {args.out}: vocab_size={info['vocab_size']}")


def _load_prepped(data_dir):
    from .data import load_dataset

    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    splits = {name: load_dataset(os.path.join(data_dir, f"{name}.npz"))
              for name in ("train", "dev", "test")
              if os.path.exists(os.path.join(data_dir, f"{name}.npz"))}
    vocab = np.load(os.path.join(data_dir, "vocab.npz"), allow_pickle=False)
    return splits, meta, vocab


def _experiment_configs(args, meta):
    from .models.mms_qa import V4
    from .training import SolverConfig, TrainerConfig
    from .utils.config import experiment_from_json

    if getattr(args, "config", None):
        with open(args.config) as f:
            return experiment_from_json(f.read())
    # no explicit --config: prefer the config the experiment was trained
    # with (written by cmd_train), so eval and serve rebuild its model
    saved = os.path.join(getattr(args, "exp", "") or "", "config.json")
    if getattr(args, "exp", None) and os.path.exists(saved):
        with open(saved) as f:
            return experiment_from_json(f.read())
    model_cfg = dataclasses.replace(
        V4, vocab_size=meta["vocab_size"], embed_dim=meta["dim"],
        question_len=meta["q_len"], answer_len=meta["a_len"])
    trainer_cfg = TrainerConfig(
        solver=SolverConfig(),
        max_iter=getattr(args, "max_iter", None) or 40001,
        snapshot_dir=os.path.join(args.exp, "models"))
    return model_cfg, trainer_cfg


def _load_model(path, device):
    """A checkpoint's params and BN state as tensors on ``device``."""
    from .convert import params_from_numpy
    from .training.checkpoint import load_checkpoint

    bundle, _ = load_checkpoint(path)
    return params_from_numpy(bundle["params"], bundle["state"], device)


def _mesh_from_args(args):
    """`caffe train -gpu 0,1,..` (tools/caffe.cpp:75-113): --mesh-dp N
    trains data-parallel over N ranks, one device each; 0 / absent = one
    device, -1 = every rank.  The ranks join through
    ``parallel.multihost.initialize`` (a launcher's environment); a mesh
    spans every rank."""
    n = getattr(args, "mesh_dp", 0) or 0
    if not n:
        return None
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import initialize

    initialize()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n == -1:
        n = world
    if n > world:
        raise SystemExit(f"--mesh-dp {n}: only {world} devices")
    if n < world:
        raise SystemExit(f"--mesh-dp {n}: {world} ranks run, and a mesh "
                         f"spans every rank")
    return make_mesh(n, 1, devices=args.device)


def _best_checkpoint(args):
    """--ckpt, else the experiment's best snapshot."""
    from .training.checkpoint import latest_checkpoint

    path = args.ckpt or latest_checkpoint(args.exp, prefix="best")
    if path is None:
        sys.exit("no checkpoint found")
    return path


# -------------------------------------------------------------------- train
def cmd_train(args):
    from .metrics import format_trec_table, trec_eval, write_trec_files
    from .training import Trainer
    from .training.checkpoint import save_checkpoint
    from .training.trainer import _SOLVERSTATES
    from .utils.config import experiment_to_json

    splits, meta, vocab = _load_prepped(args.data)
    model_cfg, trainer_cfg = _experiment_configs(args, meta)
    if args.solver_prototxt:
        # a reference solver.prototxt for the loop and the solver
        from .utils.prototxt import trainer_config_from_prototxt
        with open(args.solver_prototxt) as f:
            trainer_cfg = trainer_config_from_prototxt(
                f.read(), snapshot_dir=os.path.join(args.exp, "models"))
    if args.max_iter is not None:
        trainer_cfg = dataclasses.replace(trainer_cfg, max_iter=args.max_iter)
    if args.net_prototxt:
        model_cfg, trainer_cfg = _net_prototxt_configs(
            args.net_prototxt, meta, trainer_cfg)
    os.makedirs(args.exp, exist_ok=True)
    with open(os.path.join(args.exp, "config.json"), "w") as f:
        f.write(experiment_to_json(model_cfg, trainer_cfg))

    resume_from = None
    if args.resume:
        # bare --resume resumes the experiment's own snapshot dir
        # (`caffe train -snapshot`, tools/caffe.cpp:208-210)
        resume_from = (os.path.join(args.exp, "models")
                       if args.resume == "auto" else args.resume)
    mesh = _mesh_from_args(args)
    trainer = Trainer(model_cfg, trainer_cfg, device=args.device, mesh=mesh)
    if args.stream:
        # out-of-core batches from the MMSP packed store (C++ prefetch
        # ring) when present, else an in-memory iterator
        mmsp = os.path.join(args.data, "train.mmsp")
        if os.path.exists(mmsp):
            from .native import NativePrefetcher, PackedStore
            batches = NativePrefetcher(
                PackedStore(mmsp),
                ["question", "answer", "label", "overlap_feat"],
                batch_size=trainer_cfg.batch_size, seed=trainer_cfg.seed)
            log.info("streaming from %s", mmsp)
        else:
            from .data.loader import ArrayDataset, BatchIterator
            batches = BatchIterator(
                ArrayDataset({k: v for k, v in splits["train"].items()
                              if k != "group"}),
                trainer_cfg.batch_size, seed=trainer_cfg.seed)
        if resume_from and not resume_from.endswith(_SOLVERSTATES):
            # a snapshot records no stream cursor: skip the batches the
            # snapshot's steps took, so the resumed run sees the batches
            # the uninterrupted one would (a reference .solverstate
            # restarts the stream, as the JAX CLI does)
            ckpt = trainer._resolve_ckpt(resume_from)
            with open(os.path.join(ckpt, "meta.json")) as f:
                done = int(json.load(f)["step"]) + 1
            for _ in range(done * trainer_cfg.solver.iter_size):
                next(batches)
        hist = trainer.fit_stream(
            batches, splits["dev"], steps=trainer_cfg.max_iter,
            test_data=splits.get("test"), pretrained=vocab["pretrained"],
            patience_evals=trainer_cfg.early_stop_patience,
            handle_signals=True, resume_from=resume_from,
            weights=args.weights, log_every=50,
            steps_per_dispatch=args.fused_steps)
    else:
        hist = trainer.fit(splits["train"], splits["dev"],
                           test_data=splits.get("test"),
                           pretrained=vocab["pretrained"], log_every=50,
                           handle_signals=True, resume_from=resume_from,
                           weights=args.weights,
                           steps_per_dispatch=args.fused_steps)
    if mesh is not None and mesh.get_rank() != 0:
        return  # rank 0 writes the run's files
    save_checkpoint(args.exp, hist["best_step"],
                    {"params": hist["params"], "state": hist["state"]},
                    prefix="best", meta={"dev_map": hist["best_dev_map"]})
    print(f"best dev MAP {hist['best_dev_map']:.4f} @ step "
          f"{hist['best_step']}")

    if "test" in splits:
        res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
        scores = res["prob"][:, 1]
        truth = os.path.join(args.exp, "truth")
        result = os.path.join(args.exp, "result")
        write_trec_files(truth, result, scores, splits["test"]["label"],
                         splits["test"]["group"])
        print(format_trec_table(trec_eval(truth, result)))
    _write_curves(args.exp, hist)


def _net_prototxt_configs(path, meta, trainer_cfg):
    """A reference train-net prototxt (the network_v3/v4/v4_2/v5 family)
    -> the model config, token lengths from the prepped data; the file's
    HDF5Data batch_size drives the training batch, and the data's
    vocabulary wins over the file's."""
    from .utils.prototxt import (model_config_from_net_prototxt,
                                 parse_prototxt, upgrade_net_prototxt)

    with open(path) as f:
        net_text = f.read()
    model_cfg = model_config_from_net_prototxt(
        net_text, question_len=meta["q_len"], answer_len=meta["a_len"])
    # upgrade first: a V1-era file declares `layers:` blocks, and its
    # batch_size must drive the trainer exactly like a modern one
    layers = upgrade_net_prototxt(parse_prototxt(net_text)).get("layer", [])
    for la in (layers if isinstance(layers, list) else [layers]):
        bs = la.get("hdf5_data_param", {}).get("batch_size")
        if bs:
            trainer_cfg = dataclasses.replace(
                trainer_cfg, batch_size=bs[-1] if isinstance(bs, list)
                else bs)
            break
    if model_cfg.vocab_size != meta["vocab_size"]:
        log.warning("net prototxt vocab %d != prepped vocab %d; using the "
                    "data's", model_cfg.vocab_size, meta["vocab_size"])
        model_cfg = dataclasses.replace(model_cfg,
                                        vocab_size=meta["vocab_size"])
    return model_cfg, trainer_cfg


def _write_curves(exp_dir, hist):
    """Learning curves (curve.png / loss-curve.png analogues): json always,
    png when matplotlib imports."""
    with open(os.path.join(exp_dir, "history.json"), "w") as f:
        json.dump({k: v for k, v in hist.items()
                   if k not in ("params", "state")}, f)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001
        return
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 8))
    steps = hist["steps"]
    for key, color in (("dev_map", "m"), ("dev_mrr", "y"), ("dev_auc", "k"),
                       ("test_map", "r"), ("test_mrr", "g"),
                       ("test_auc", "b")):
        if hist.get(key):
            ax1.plot(steps[: len(hist[key])], hist[key], color, label=key)
    ax1.legend(loc=4, ncol=2, fontsize=8)
    ax1.set_xlabel("iteration")
    ax2.plot(np.arange(len(hist["train_loss"])), hist["train_loss"], "r",
             label="train loss")
    ax2.legend()
    fig.savefig(os.path.join(exp_dir, "curve.png"))
    plt.close(fig)


# --------------------------------------------------------------------- eval
def cmd_eval(args):
    from .metrics import format_trec_table, trec_eval
    from .training import Trainer
    from .training.checkpoint import latest_checkpoint

    splits, meta, vocab = _load_prepped(args.data)
    model_cfg, trainer_cfg = _experiment_configs(args, meta)
    path = args.ckpt or latest_checkpoint(args.exp, prefix="best") or \
        latest_checkpoint(os.path.join(args.exp, "models"))
    if path is None:
        sys.exit("no checkpoint found")
    trainer = Trainer(model_cfg, trainer_cfg, device=args.device)
    params, state = _load_model(path, trainer.device)
    split = splits[args.split]
    res = trainer.evaluate(params, state, split)
    ev = trec_eval(scores=res["prob"][:, 1], labels=split["label"],
                   groups=split["group"])
    print(format_trec_table(ev))
    print(json.dumps({"in_graph_map": float(res["map"]),
                      "in_graph_mrr": float(res["mrr"]),
                      "auc": float(res["auc"]),
                      "trec_map": ev.get("map"),
                      "trec_mrr": ev.get("recip_rank")}))


# -------------------------------------------------------------------- serve
def cmd_serve(args):
    global _LAST_SERVER
    from .device import resolve_device
    from .serve import QAServer, QueryEngine

    splits, meta, vocab = _load_prepped(args.data)
    model_cfg, _ = _experiment_configs(args, meta)
    path = _best_checkpoint(args)
    device = resolve_device(args.device)
    params, state = _load_model(path, device)
    split = splits[args.split]
    pd = args.pool_dtype or ("int8" if args.int8 else "bf16")
    engine = QueryEngine(params, model_cfg, pool_dtype=pd, device=device)
    if args.index and os.path.exists(args.index):
        # warm restart: skip re-embedding and re-clustering the pool
        engine.load_index(args.index)
        print(json.dumps({"index_loaded": args.index,
                          "pool": engine.pool_size,
                          "ivf": engine.ivf is not None}), flush=True)
    else:
        engine.build_index(split["answer"])
        if args.ivf_clusters:
            engine.build_ivf(n_clusters=args.ivf_clusters,
                             coarse_tokens=args.coarse_tokens)
        if args.index:
            engine.save_index(args.index)
            print(json.dumps({"index_saved": args.index}), flush=True)
    if args.listen is not None:
        # the persistent HTTP retrieval service (serve/server.py) over the
        # built index; raw-text queries tokenize with the prepped vocab
        srv = QAServer(engine, state=state, vocab_words=vocab["words"],
                       host=args.host, port=args.listen, default_k=args.k,
                       batch_window_ms=args.batch_window_ms)
        print(json.dumps({"listening": f"http://{srv.host}:{srv.port}",
                          "pool": engine.pool_size}), flush=True)
        _LAST_SERVER = srv
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.close()
        return
    n = min(args.n_queries, len(split["question"]))
    if args.rerank:
        # two-phase: kernel shortlist -> exact model rescoring
        vals, idx = engine.query_rerank(state, split["question"][:n],
                                        k=args.k, shortlist=args.rerank)
    else:
        vals, idx = engine.query(split["question"][:n], k=args.k)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    for qi in range(n):
        print(json.dumps({"query": qi,
                          "topk": [[int(i), float(v)]
                                   for i, v in zip(idx[qi], vals[qi])]}))


# ------------------------------------------------------------------- tools
def cmd_extract(args):
    """Dump a split's token embeddings and probabilities as npz (the
    `extract_features` tool's role)."""
    import torch

    from .ops.embed import embed_lookup
    from .training import Trainer

    splits, meta, vocab = _load_prepped(args.data)
    model_cfg, trainer_cfg = _experiment_configs(args, meta)
    trainer = Trainer(model_cfg, trainer_cfg, device=args.device)
    params, state = _load_model(_best_checkpoint(args), trainer.device)
    split = splits[args.split]
    res = trainer.evaluate(params, state, split)
    with torch.no_grad():
        emb = {k: embed_lookup(params["embed"], torch.as_tensor(
            split[k], device=trainer.device)).cpu().numpy()
            for k in ("question", "answer")}
    out_path = args.out or os.path.join(args.exp,
                                        f"features_{args.split}.npz")
    np.savez_compressed(out_path,
                        prob=res["prob"],
                        question_embeddings=emb["question"],
                        answer_embeddings=emb["answer"],
                        label=split["label"], group=split["group"])
    print(f"wrote {out_path}")


def cmd_saliency(args):
    """Per-token saliency heatmaps for the first N pairs of a split (the
    reference's test_networks_single analysis)."""
    import torch

    from .device import resolve_device
    from .utils.saliency import save_saliency_png, token_saliency

    splits, meta, vocab = _load_prepped(args.data)
    model_cfg, _ = _experiment_configs(args, meta)
    device = resolve_device(args.device)
    params, state = _load_model(_best_checkpoint(args), device)
    split = splits[args.split]
    n = min(args.n, len(split["label"]))
    batch = {k: torch.as_tensor(v[:n], device=device)
             for k, v in split.items() if k != "group"}
    q_sal, a_sal = token_saliency(params, state, batch, model_cfg)
    out = args.out or os.path.join(args.exp, "saliency.png")
    np.savez_compressed(os.path.splitext(out)[0] + ".npz",
                        question_saliency=q_sal, answer_saliency=a_sal)
    if save_saliency_png(out, q_sal, a_sal):
        print(f"wrote {out}")
    print(f"wrote {os.path.splitext(out)[0]}.npz")


def cmd_summarize(args):
    """The model's layer table (tools/extra/summarize.py's role) and an
    optional history.json as train / eval CSVs."""
    from .utils.history import history_to_csv, summarize_model

    if args.config:
        from .utils.config import experiment_from_json
        with open(args.config) as f:
            model_cfg, _ = experiment_from_json(f.read())
    else:
        from .models.mms_qa import V3, V4, V4_2, V5
        model_cfg = {"v3": V3, "v4": V4, "v4_2": V4_2,
                     "v5": V5}[args.variant]
    print(summarize_model(model_cfg))
    if args.history:
        with open(args.history) as f:
            hist = json.load(f)
        train_csv, eval_csv = history_to_csv(hist)
        base = os.path.splitext(args.history)[0]
        with open(base + ".train.csv", "w") as f:
            f.write(train_csv)
        with open(base + ".eval.csv", "w") as f:
            f.write(eval_csv)
        print(f"wrote {base}.train.csv / {base}.eval.csv")


def cmd_parse_log(args):
    """tools/extra/parse_log.py: a training log -> `<log>.train` /
    `<log>.test` CSV tables."""
    from .utils.parse_log import parse_log_file

    train_path, test_path = parse_log_file(args.log, out_dir=args.out_dir)
    print(f"wrote {train_path}\nwrote {test_path}")


def cmd_reproduce(args):
    """The real-data parity gate: the published recipe (V4, AdaDelta,
    batch 50, eval every 100 steps, patience 5 epochs, seed 22) from the
    raw inputs, TREC-QA XML and GloVe vectors; prints the trec_eval table
    and exits 1 unless MAP and MRR land within ``--tolerance`` of the
    published 0.7793 / 0.8487."""
    from .data import prepare_trec_qa
    from .metrics import format_trec_table, trec_eval, write_trec_files
    from .models.mms_qa import V4
    from .ops.embed import load_pretrained_vectors
    from .training import SolverConfig, Trainer, TrainerConfig

    words, vecs = load_pretrained_vectors(args.glove, args.dim)
    w2v = dict(zip(words, vecs))
    log.info("loaded %d pretrained vectors", len(w2v))
    splits, info = prepare_trec_qa(args.train_xml, args.dev_xml,
                                   args.test_xml, w2v,
                                   q_len=args.q_len, a_len=args.a_len)
    for name, split in splits.items():
        log.info("%s: %d pairs", name, len(split["label"]))
    model_cfg = dataclasses.replace(
        V4, vocab_size=info["vocab_size"], embed_dim=args.dim,
        question_len=args.q_len, answer_len=args.a_len)
    trainer_cfg = TrainerConfig(
        solver=SolverConfig(solver_type="adadelta", base_lr=1.0,
                            momentum=0.95, delta=5e-7, weight_decay=5e-4),
        max_iter=args.max_iter, batch_size=50, test_interval=100,
        early_stop_patience=5, seed=22, snapshot_interval=0,
        snapshot_dir=None)
    os.makedirs(args.out, exist_ok=True)
    trainer = Trainer(model_cfg, trainer_cfg, device=args.device)
    hist = trainer.fit(splits["train"], splits["dev"],
                       pretrained=info["pretrained"], log_every=100,
                       steps_per_dispatch=args.fused_steps or 1)
    log.info("best dev MAP %.4f @ step %d", hist["best_dev_map"],
             hist["best_step"])
    res = trainer.evaluate(hist["params"], hist["state"], splits["test"])
    truth = os.path.join(args.out, "truth")
    result = os.path.join(args.out, "result")
    write_trec_files(truth, result, res["prob"][:, 1],
                     splits["test"]["label"], splits["test"]["group"])
    ev = trec_eval(truth, result)
    print(format_trec_table(ev))
    with open(os.path.join(args.out, "trec_eval.json"), "w") as f:
        json.dump(dict(ev.items()), f, indent=1)
    got_map, got_mrr = float(ev["map"]), float(ev["recip_rank"])
    ok = (abs(got_map - args.expected_map) <= args.tolerance
          and abs(got_mrr - args.expected_mrr) <= args.tolerance)
    verdict = "PASS" if ok else "FAIL"
    print(f"reproduce {verdict}: MAP {got_map:.4f} (expected "
          f"{args.expected_map:.4f} +/- {args.tolerance}), MRR "
          f"{got_mrr:.4f} (expected {args.expected_mrr:.4f} +/- "
          f"{args.tolerance})")
    if not ok:
        sys.exit(1)


def cmd_image_mean(args):
    """`compute_image_mean` (tools/compute_image_mean.cpp): the mean image
    over a list (pair or `path label` rows) -> a legacy-dim BlobProto, with
    the tool's per-channel lines."""
    from .data.pair_image import compute_image_mean
    from .utils.caffemodel import save_blob_binaryproto

    mean = compute_image_mean(args.list, root=args.root,
                              new_height=args.new_height,
                              new_width=args.new_width)   # HWC
    nchw = mean.transpose(2, 0, 1)[None]                  # (1, C, H, W)
    if args.out:
        save_blob_binaryproto(args.out, nchw)
        print(f"wrote {args.out} shape {nchw.shape}")
    for c in range(nchw.shape[1]):
        print(f"mean_value channel [{c}]: {float(nchw[0, c].mean()):.6g}")


def cmd_solve(args):
    """The reference's `caffe train --solver=...`: any NetParameter
    prototxt through GraphSolver (test passes, smoothed-loss display,
    snapshots, resume).  Prints the last iteration, the smoothed loss and
    each test net's last outputs as one JSON line."""
    from .training.graph_solver import GraphSolver
    from .training.signals import SignalHandler

    mesh = _mesh_from_args(args)
    gs = GraphSolver(args.solver, device=args.device, mesh=mesh)
    if args.snapshot:
        gs.restore(args.snapshot)
    elif args.weights:
        # a comma-separated list, applied in order (caffe.cpp:139-154)
        for w in args.weights.split(","):
            report = gs.copy_weights(w)
            log.info("copied weights from %s: %s", w, report)
    # SIGINT -> stop (snapshot and leave the loop), SIGHUP -> snapshot and
    # carry on (caffe.cpp:44-49)
    with SignalHandler() as h:
        loss = gs.solve(action_fn=h.get_requested_action)
    # the last test record of each test net
    last_by_net: dict = {}
    for rec in gs.history:
        if rec["phase"].startswith("Test"):
            last_by_net[rec["phase"]] = {
                k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in rec.items() if k not in ("iter", "phase")}
    tests = (last_by_net.get("Test#0", {}) if len(last_by_net) <= 1
             else last_by_net)
    print(json.dumps({"iter": gs.iter_, "loss": float(loss),
                      "last_test": tests}))


def _test_feeds(net, model_path: str, seed: int) -> list:
    """Fresh TEST-phase feeds of ``net``'s data layers, their sources
    resolved beside the prototxt at ``model_path``."""
    from .models.graph_net import DATA_TYPES
    from .training.graph_solver import _build_feed

    base_dir = os.path.dirname(os.path.abspath(model_path))
    return [f for f in (_build_feed(n.cfg, "test", seed, base_dir, None)
                        for n in net.layers if n.type in DATA_TYPES)
            if f is not None]


def _next_batch(feeds, device) -> dict:
    """Every feed's next batch, merged, as tensors on ``device``."""
    import torch

    batch = {}
    for f in feeds:
        batch.update(next(f))
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def _nettest_forward(net, params, state):
    """One `caffe test` iteration's body: a batch -> the output blobs as
    float32 (its plain version is a direct call)."""
    import torch

    names = net.output_blob_names()

    def body(batch):
        blobs, _ = net.apply(params, state, batch, train=False)
        return {t: blobs[t].to(torch.float32) for t in names}

    return body


def _features_forward(net, params, state, blob_names):
    """One `extract_features` iteration's body: (a batch, generators=[its
    generator]) -> the named blobs."""
    def body(batch, generators):
        blobs, _ = net.apply(params, state, batch, train=False,
                             generator=generators[0])
        return {b: blobs[b] for b in blob_names}

    return body


def cmd_nettest(args):
    """The reference's `caffe test`: score any net prototxt in TEST phase
    for N iterations with given weights, averaging every output-blob
    element; loss is the mean weighted loss over the iterations.  On the
    card each iteration is one CUDA graph replay (eager on the CPU); the
    host reads its cloned outputs."""
    import torch

    from .device import resolve_device
    from .models.graph_net import GraphNet
    from .utils.graphs import GraphedCall

    device = resolve_device(args.device)
    with open(args.model) as f:
        net = GraphNet(f.read(), phase="test")
    feeds = _test_feeds(net, args.model, 0)
    example = _next_batch(feeds, device)
    params, state = net.init(torch.Generator().manual_seed(0), example,
                             device=device)
    feeds = _test_feeds(net, args.model, 0)  # init only peeked for shapes
    if args.weights:
        from .utils.caffemodel import load_caffemodel_auto
        params, state, report = load_caffemodel_auto(
            args.weights, params, state,
            specs=net.caffemodel_specs(params, state))
        log.info("loaded weights: %s", report)
    names = net.output_blob_names()
    weights_map = net.blob_loss_weights()
    calls = GraphedCall(device, name="nettest")
    body = _nettest_forward(net, params, state)
    total, loss = None, 0.0
    for _ in range(args.iterations):
        out = calls(("nettest",), body, _next_batch(feeds, "cpu"),
                    fixed=(params, state))
        loss += sum(w * float(torch.sum(out[t]))
                    for t, w in weights_map.items())
        total = out if total is None else \
            {k: total[k] + v for k, v in out.items()}
    result = {}
    for name in names:
        mean = np.ravel(total[name].cpu().numpy()) / args.iterations
        w = weights_map.get(name, 0.0)
        for v in mean:
            msg = f"{name} = {v}"
            if w:
                msg += f" (* {w} = {w * v} loss)"
            log.info("%s", msg)
        result[name] = mean.tolist() if mean.size > 1 else float(mean[0])
    result["loss"] = loss / args.iterations
    print(json.dumps(result))


# -------------------------------------------------- the reference's tools
def cmd_convert(args):
    """Weight-format conversion, both directions:

    export: convert --ckpt DIR --out model.caffemodel[.h5]
    import: convert --caffemodel model.caffemodel[.h5] --data DIR --out CKPT_DIR

    The reference's Net::ToProto / ToHDF5 and CopyTrainedLayersFrom layouts
    (net.cpp:797-913); ``--out x.prototxt`` writes the config as the
    reference's train / eval / solver prototxts, and ``--out
    x.solverstate[.h5]`` a resumable pair.  HDF5 files need h5py;
    binaryproto files do not."""
    import torch

    from .training.checkpoint import load_checkpoint, save_checkpoint
    from .utils.caffemodel import (load_caffemodel_auto,
                                   save_caffemodel_binaryproto,
                                   save_caffemodel_h5)

    if args.caffemodel:  # import
        from .models.mms_qa import mms_qa_init

        splits, meta, vocab = _load_prepped(args.data)
        args.exp = args.exp or args.out  # default snapshot root
        model_cfg, trainer_cfg = _experiment_configs(args, meta)
        params, state = mms_qa_init(
            model_cfg, generator=torch.Generator().manual_seed(
                trainer_cfg.seed), device="cpu")
        # dispatch on the HDF5 magic: files get renamed, content beats names
        params, state, report = load_caffemodel_auto(args.caffemodel,
                                                     params, state)
        loaded = sum(1 for v in report.values() if v == "loaded")
        save_checkpoint(args.out, 0, {"params": params, "state": state},
                        prefix="imported",
                        meta={"source": args.caffemodel})
        print(json.dumps({"imported": loaded,
                          "report": report, "out": args.out}))
    elif args.out.endswith(".prototxt"):
        # our typed config -> the reference prototxt trio (train net, eval
        # net with metric heads, solver): do_trec_qa_clean.py:350-615
        from .utils.config import experiment_from_json
        from .utils.prototxt import (net_prototxt_from_config,
                                     solver_prototxt_from_config)

        cfg_path = args.config or (
            os.path.join(args.exp, "config.json") if args.exp else None)
        if not cfg_path or not os.path.exists(cfg_path):
            sys.exit("prototxt export needs --config (or --exp with a "
                     "saved config.json)")
        with open(cfg_path) as f:
            model_cfg, trainer_cfg = experiment_from_json(f.read())
        base = args.out[: -len(".prototxt")]
        with open(args.out, "w") as f:
            f.write(net_prototxt_from_config(
                model_cfg, batch_size=trainer_cfg.batch_size))
        with open(base + "_eval.prototxt", "w") as f:
            f.write(net_prototxt_from_config(model_cfg, phase="eval"))
        with open(base + "_solver.prototxt", "w") as f:
            f.write(solver_prototxt_from_config(
                trainer_cfg, train_net=os.path.basename(args.out)))
        print(json.dumps({"exported": [args.out,
                                       base + "_eval.prototxt",
                                       base + "_solver.prototxt"]}))
    else:  # export
        if not args.ckpt:
            sys.exit("convert needs --ckpt (export) or --caffemodel "
                     "(import)")
        bundle, meta = load_checkpoint(args.ckpt)
        if args.out.endswith((".solverstate", ".solverstate.h5")):
            # OUT.solverstate[.h5] + a sibling .caffemodel[.h5] (what
            # `caffe train -snapshot` reads), format by suffix
            from .utils.caffemodel import (save_solverstate_binaryproto,
                                           save_solverstate_h5)
            if "opt_state" not in bundle:
                sys.exit("checkpoint has no opt_state (training snapshot "
                         "required for a .solverstate export)")
            h5 = args.out.endswith(".h5")
            stem = args.out[: -len(".solverstate.h5" if h5
                                   else ".solverstate")]
            weights = stem + (".caffemodel.h5" if h5 else ".caffemodel")
            (save_caffemodel_h5 if h5 else save_caffemodel_binaryproto)(
                weights, bundle["params"], bundle.get("state") or {})
            (save_solverstate_h5 if h5 else save_solverstate_binaryproto)(
                args.out, bundle["params"], bundle.get("state") or {},
                bundle["opt_state"], int(meta.get("step", 0)) + 1,
                learned_net=os.path.basename(weights))
            print(json.dumps({"exported": args.out, "weights": weights}))
        else:
            saver = save_caffemodel_h5 if args.out.endswith(".h5") \
                else save_caffemodel_binaryproto
            saver(args.out, bundle["params"], bundle.get("state") or {})
            print(json.dumps({"exported": args.out}))


def cmd_draw(args):
    """`draw_net.py`: net prototxt -> Graphviz DOT text
    (python/caffe/draw.py get_pydot_graph; render with any dot tool)."""
    from .utils.draw import net_to_dot

    with open(args.net) as f:
        text = f.read()
    dot = net_to_dot(text, phase=args.phase, rankdir=args.rankdir)
    if args.out:
        with open(args.out, "w") as f:
            f.write(dot)
        print(f"wrote {args.out}")
    else:
        print(dot, end="")


def cmd_convert_imageset(args):
    """tools/convert_imageset.cpp: a `path label` list -> a dataset the
    data layers read: uint8 Datums in an LMDB or LevelDB (the reference's
    artifact, read by Data layers), or chunked HDF5 + a list file for
    HDF5Data layers.  Only the hdf5 backend needs h5py."""
    from .data.pair_image import load_image

    with open(args.listfile) as f:
        rows = [(ln.rsplit(None, 1)[0], float(ln.rsplit(None, 1)[1]))
                for ln in (s.strip() for s in f) if ln]
    if not rows:
        raise SystemExit(f"empty image list {args.listfile}")
    if args.shuffle:
        # convert_imageset.cpp:58-62 shuffles the LINES once up front
        np.random.default_rng(args.seed).shuffle(rows)

    imgs, labels = [], []
    shape = None
    for path, label in rows:
        arr = load_image(os.path.join(args.root, path),
                         new_height=args.resize_height,
                         new_width=args.resize_width,
                         is_color=not args.gray)
        if shape is None:
            shape = arr.shape
        elif arr.shape != shape and args.backend == "hdf5":
            # HDF5 rows must stack (Datums may differ row by row)
            raise SystemExit(
                f"{path}: shape {arr.shape} != first image {shape} "
                "(use --resize-height/--resize-width)")
        imgs.append(arr)
        labels.append(label)

    if args.backend in ("lmdb", "leveldb"):
        # uint8 (C, H, W) Datums keyed "%08d_%path"
        # (convert_imageset.cpp:140-156), in either DB
        from .utils.io import array_to_datum

        entries = []
        for i, ((path, label), arr) in enumerate(zip(rows, imgs)):
            chw = np.transpose(np.clip(arr, 0, 255).astype(np.uint8),
                               (2, 0, 1))
            entries.append((f"{i:08d}_{path}".encode(),
                            array_to_datum(chw, int(label))))
        if args.backend == "lmdb":
            from .utils.lmdb_io import write_lmdb
            out = write_lmdb(args.out, entries)
        else:
            from .utils.leveldb_io import write_leveldb
            out = write_leveldb(args.out, entries, sst=True)
        print(f"Processed {len(rows)} files.")
        print(f"wrote {out}")
        return

    import h5py

    os.makedirs(args.out, exist_ok=True)
    data = np.stack(imgs).astype(np.float32)
    lab = np.asarray(labels, np.float64)
    list_path = os.path.join(args.out, f"{args.name}.txt")
    with open(list_path, "w") as lf:
        for i in range(0, len(rows), args.chunk_rows):
            path = os.path.join(args.out,
                                f"data{i // args.chunk_rows}.h5")
            with h5py.File(path, "w") as h5:
                h5["data"] = data[i:i + args.chunk_rows]
                h5["label"] = lab[i:i + args.chunk_rows]
            lf.write(path + "\n")
    print(f"Processed {len(rows)} files.")
    print(f"wrote {list_path}")


def cmd_extract_features(args):
    """tools/extract_features.cpp: run a net in TEST phase for N
    mini-batches with trained weights, saving each named blob's values
    (one .npy per blob, concatenated over batches; the reference writes
    one LMDB per blob instead)."""
    import torch

    from .device import resolve_device
    from .models.graph_net import GraphNet
    from .training.trainer import derive_seed
    from .utils.graphs import GraphedCall

    device = resolve_device(args.device)
    with open(args.model) as f:
        net = GraphNet(f.read(), phase="test")
    blob_names = [b for b in args.blobs.split(",") if b]
    known = set(net.input_names)
    for node in net.layers:
        known.update(node.tops)
    for b in blob_names:
        if b not in known:  # extract_features.cpp:93's has_blob CHECK
            raise SystemExit(f"Unknown feature blob name {b} in the "
                             f"network {args.model}")

    feeds = _test_feeds(net, args.model, args.seed)
    params, state = net.init(torch.Generator().manual_seed(args.seed),
                             _next_batch(feeds, device), device=device)
    if args.weights:
        from .utils.caffemodel import load_caffemodel_auto

        params, state, _ = load_caffemodel_auto(
            args.weights, params, state,
            specs=net.caffemodel_specs(params, state))
    # init only peeked for shapes: restart at batch 0
    feeds = _test_feeds(net, args.model, args.seed)
    calls = GraphedCall(device, name="extract_features")
    body = _features_forward(net, params, state, blob_names)
    acc: dict = {b: [] for b in blob_names}
    for i in range(args.iterations):
        # one replay on the card; the host reads its cloned outputs
        out = calls(("extract_features",), body, _next_batch(feeds, "cpu"),
                    fixed=(params, state),
                    generators=(derive_seed(args.seed, 0xFEA7, i),))
        for b in blob_names:
            acc[b].append(out[b].cpu().numpy())
    os.makedirs(args.out, exist_ok=True)
    for b in blob_names:
        stacked = np.concatenate(acc[b], axis=0)
        dest = os.path.join(args.out, f"{b}.npy")
        np.save(dest, stacked)
        print(f"wrote {dest} {stacked.shape}")
    print(f"Successfully extracted {len(blob_names)} features for "
          f"{args.iterations} batches")


def cmd_upgrade(args):
    """tools/upgrade_net_proto_text.cpp + upgrade_solver_proto_text.cpp
    (and, with --binary, upgrade_net_proto_binary.cpp): read a (possibly
    V0/V1-era) prototxt or binary NetParameter, upgrade it to the modern
    schema, write it back."""
    from .utils.prototxt import (emit_prototxt, parse_prototxt,
                                 upgrade_net_prototxt,
                                 upgrade_solver_prototxt)

    if args.binary:
        from .utils.proto_wire import (collect_dropped_unknowns,
                                       decode_net_binary,
                                       encode_net_binary, strip_blobs)

        if not args.out:
            raise SystemExit("--binary needs an explicit output path")
        with open(args.input, "rb") as f:
            d = decode_net_binary(f.read())
        for path, num in collect_dropped_unknowns(d):
            print(f"warning: dropping unknown field {num} at {path}")
        up = upgrade_net_prototxt(d)
        if args.out.endswith((".prototxt", ".txt")):
            # structure only: blob payloads are not text
            with open(args.out, "w") as f:
                f.write(emit_prototxt(strip_blobs(up)) + "\n")
        else:
            with open(args.out, "wb") as f:
                f.write(encode_net_binary(up))
        print(f"wrote {args.out} (net, from binary)")
        return
    with open(args.input) as f:
        d = parse_prototxt(f.read())
    kind = args.kind
    if kind == "auto":
        kind = ("net" if any(k in d for k in ("layer", "layers", "input"))
                else "solver")
    up = (upgrade_net_prototxt(d) if kind == "net"
          else upgrade_solver_prototxt(d))
    text = emit_prototxt(up) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out} ({kind})")
    else:
        print(text, end="")


def _load_mean(path, *, per_channel=False):
    """A mean file (.npy, CHW or per-channel, or mean.binaryproto) in
    caffe CHW; ``per_channel`` collapses a full mean to its channel means
    (detect.py:104-106)."""
    if path.endswith(".npy"):
        mean = np.load(path)
    else:
        from .utils.caffemodel import load_blob_binaryproto

        mean = np.asarray(load_blob_binaryproto(path), np.float32)
        mean = mean[0] if mean.ndim == 4 else mean
    if per_channel and mean.ndim == 3 and mean.shape[1:] != (1, 1):
        mean = mean.mean(1).mean(1)
    return mean


def cmd_classify(args):
    """python/classify.py: images (file / dir glob / .npy stack) -> (N, C)
    class-probability .npy through ``Classifier``."""
    import glob as globmod
    import time

    from .models.classifier import Classifier
    from .utils import io as caffe_io

    image_dims = [int(s) for s in args.images_dim.split(",")]
    mean = _load_mean(args.mean_file) if args.mean_file else None
    channel_swap = ([int(s) for s in args.channel_swap.split(",")]
                    if args.channel_swap else None)
    clf = Classifier(args.model_def, args.pretrained_model,
                     image_dims=image_dims, mean=mean,
                     input_scale=args.input_scale,
                     raw_scale=args.raw_scale, channel_swap=channel_swap,
                     device=args.device)

    src = os.path.expanduser(args.input_file)
    if src.endswith(".npy"):
        arr = np.load(src)
        # an (N, H, W, K) stack or a single (H, W, K) image
        inputs = list(arr) if arr.ndim == 4 else [arr]
    elif os.path.isdir(src):
        inputs = [caffe_io.load_image(f) for f in
                  sorted(globmod.glob(os.path.join(src, "*." + args.ext)))]
    else:
        inputs = [caffe_io.load_image(src)]
    print(f"Classifying {len(inputs)} inputs.")

    start = time.time()
    predictions = clf.predict(inputs, not args.center_only)
    print(f"Done in {time.time() - start:.2f} s.")
    np.save(args.output_file, predictions)
    print(f"Saving results into {args.output_file}")


def cmd_detect(args):
    """python/detect.py: a window CSV (filename,ymin,xmin,ymax,xmax) ->
    per-window class scores (CSV or .npz) through ``Detector``."""
    import csv
    import time

    from .models.detector import Detector

    mean = (_load_mean(args.mean_file, per_channel=True)
            if args.mean_file else None)
    channel_swap = ([int(s) for s in args.channel_swap.split(",")]
                    if args.channel_swap else None)
    det = Detector(args.model_def, args.pretrained_model, mean=mean,
                   input_scale=args.input_scale, raw_scale=args.raw_scale,
                   channel_swap=channel_swap,
                   context_pad=args.context_pad, device=args.device)

    if not args.input_file.lower().endswith(".csv"):
        raise SystemExit("input must be a CSV with header "
                         "filename,ymin,xmin,ymax,xmax (the selective-"
                         "search txt mode needs the external MATLAB "
                         "package, same as the reference)")
    by_file: dict = {}
    with open(args.input_file, newline="") as f:
        for row in csv.DictReader(f):
            by_file.setdefault(row["filename"], []).append(np.array(
                [int(float(row[k]))
                 for k in ("ymin", "xmin", "ymax", "xmax")]))
    t = time.time()
    detections = det.detect_windows(sorted(by_file.items()))
    print(f"Processed {len(detections)} windows in "
          f"{time.time() - t:.3f} s.")

    if args.output_file.lower().endswith(".csv"):
        n_cls = len(detections[0]["prediction"])
        with open(args.output_file, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["filename", "ymin", "xmin", "ymax", "xmax"]
                       + [f"class{i}" for i in range(n_cls)])
            for d in detections:
                w.writerow([d["filename"], *map(int, d["window"]),
                            *map(float, d["prediction"])])
    else:
        np.savez(args.output_file,
                 filenames=np.array([d["filename"] for d in detections]),
                 windows=np.stack([d["window"] for d in detections]),
                 predictions=np.stack([d["prediction"]
                                       for d in detections]))
    print(f"Saved to {args.output_file}")


def cmd_device_query(args):
    """One JSON line per device: the JAX CLI's keys (id, platform, kind,
    process) and, for a CUDA device, its properties."""
    import torch

    from .device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cpu":
        print(json.dumps({"id": 0, "platform": "cpu", "kind": "cpu",
                          "process": 0}))
        return
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        print(json.dumps({"id": i, "platform": "gpu", "kind": p.name,
                          "process": 0,
                          "capability": f"{p.major}.{p.minor}",
                          "multiprocessors": p.multi_processor_count,
                          "total_memory": p.total_memory,
                          "free_memory": free,
                          "torch": torch.__version__,
                          "cuda": torch.version.cuda}))


# ------------------------------------------------------------------- export
def cmd_export(args):
    """Freeze the eval forward and the weights into one ``torch.export``
    artifact (``deploy.py``); the reference's analog is the frozen
    .caffemodel + deploy-prototxt pair C++ caffe consumes
    (tools/caffe.cpp:229-296).  The program is the one for the device it
    was exported on; ``deploy.load_scorer`` moves it to another."""
    from .deploy import save_scorer

    _, meta, _ = _load_prepped(args.data)
    model_cfg, _ = _experiment_configs(args, meta)
    params, state = _load_model(_best_checkpoint(args), args.device)
    header = save_scorer(args.out, params, state, model_cfg, batch=args.batch)
    print(json.dumps({"out": args.out, **header}))


# --------------------------------------------------------------------- time
def _time_model(args, device):
    """`caffe time --model=any.prototxt`: the whole net's training-mode
    forward and, when it has a loss, forward plus backward, through
    GraphNet (per-layer times of an eager net would time the host)."""
    import torch

    from .models.graph_net import GraphNet
    from .utils.timer import benchmark, trace
    from .utils.tree import tree_leaves, tree_map

    with open(args.model) as f:
        net = GraphNet(f.read(), phase="train")
    shapes = net.declared_input_shapes()
    missing = [n for n in net.input_names if n not in shapes]
    if missing:
        raise SystemExit(
            f"net declares no shapes for inputs {missing}; add "
            f"input_shape/input_param declarations (deploy style) "
            f"or DummyData layers")
    ins = {k: torch.zeros(v, dtype=torch.float32, device=device)
           for k, v in shapes.items()}
    params, state = net.init(torch.Generator().manual_seed(0), ins,
                             device=device)
    gen = torch.Generator(device=device)

    @torch.no_grad()
    def fwd():
        blobs, _ = net.apply(params, state, ins, train=True,
                             generator=gen.manual_seed(1))
        return sum(torch.sum(b.to(torch.float32)) for b in blobs.values()
                   if torch.is_tensor(b) and b.is_floating_point())

    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]

    def fwdbwd():
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        loss, _ = net.loss(p, state, ins, generator=gen.manual_seed(1))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return sum(torch.sum(torch.abs(g)) for g in grads if g is not None)

    has_loss = bool(net.blob_loss_weights())
    with trace(args.xprof) if args.xprof else contextlib.nullcontext():
        f_res = benchmark(fwd, iters=args.iters)
        fb_res = benchmark(fwdbwd, iters=args.iters) if has_loss else None
    out = {"model": args.model,
           "full_forward_ms": round(f_res["p50_s"] * 1e3, 4)}
    if fb_res is not None:
        out["full_forward_backward_ms"] = round(fb_res["p50_s"] * 1e3, 4)
    else:
        out["note"] = "net has no loss layer; backward skipped"
    if args.xprof:
        out["xprof"] = args.xprof
    return out


def _time_serve(args, device):
    """The serving lifecycle on a synthetic pool: build / save / load /
    query p50 at 1 and 32 queries / add / remove / compact, each fenced by
    a wait for the card."""
    import tempfile
    import time

    import torch

    from .models.mms_qa import V4, mms_qa_init
    from .serve import QueryEngine

    cfg = dataclasses.replace(V4, vocab_size=20000)
    params, _ = mms_qa_init(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    rng = np.random.default_rng(0)
    n = args.serve_pool
    cand = rng.integers(0, cfg.vocab_size, (n, cfg.answer_len))
    pd = args.pool_dtype or "int8"

    def wall(fn):
        t0 = time.perf_counter()
        r = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return r, (time.perf_counter() - t0) * 1e3

    eng = QueryEngine(params, cfg, pool_dtype=pd, device=device)
    _, build_ms = wall(lambda: eng.build_index(cand))
    out = {"pool": n, "pool_dtype": pd, "build_index_ms": round(build_ms, 1)}
    with tempfile.TemporaryDirectory() as td:
        pth = os.path.join(td, "index.npz")
        _, save_ms = wall(lambda: eng.save_index(pth))
        eng2 = QueryEngine(params, cfg, pool_dtype=pd, device=device)
        _, load_ms = wall(lambda: eng2.load_index(pth))
        out["save_index_ms"] = round(save_ms, 1)
        out["load_index_ms"] = round(load_ms, 1)
        del eng2
    for nq in (1, 32):
        q = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (nq, cfg.question_len)),
                            device=device)
        wall(lambda: eng.query(q, k=10))  # warm
        times = sorted(wall(lambda: eng.query(q, k=10))[1]
                       for _ in range(args.iters))
        out[f"query_{nq}q_p50_ms"] = round(times[len(times) // 2], 2)
    n_add = min(1024, n)
    add_rows = rng.integers(0, cfg.vocab_size, (n_add, cfg.answer_len))
    _, add_ms = wall(lambda: eng.add_candidates(add_rows))
    out[f"add_{n_add}_ms"] = round(add_ms, 1)
    n_rm = min(100, n)
    _, rm_ms = wall(lambda: eng.remove_candidates(list(range(n_rm))))
    out[f"remove_{n_rm}_ms"] = round(rm_ms, 1)
    _, compact_ms = wall(lambda: eng.compact())
    out["compact_ms"] = round(compact_ms, 1)
    return out


def cmd_time(args):
    """Per-stage forward and backward times and whole-step numbers:
    `caffe time` (tools/caffe.cpp:301-387 reports per-layer forward AND
    backward ms over the train net), on the card unless --device cpu."""
    import torch

    from .device import resolve_device
    from .models.mms_qa import V4, mms_qa_apply, mms_qa_init
    from .training import Trainer, TrainerConfig
    from .utils.timer import benchmark, stage_times_fwd_bwd, trace

    device = resolve_device(args.device)
    if args.model:
        print(json.dumps(_time_model(args, device)))
        return
    if args.serve_pool:
        print(json.dumps(_time_serve(args, device)))
        return

    cfg = dataclasses.replace(V4, vocab_size=20000)
    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        0), device=device)
    rng = np.random.default_rng(0)
    batch = {
        "question": rng.integers(0, 20000, (args.batch, 40)),
        "answer": rng.integers(0, 20000, (args.batch, 40)),
        "overlap_feat": rng.random((args.batch, 2)).astype(np.float32),
        "label": rng.integers(0, 2, (args.batch,)),
    }
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    with trace(args.xprof) if args.xprof else contextlib.nullcontext():
        stages = stage_times_fwd_bwd(params, state, batch, cfg,
                                     iters=args.iters)
        with torch.no_grad():
            full = benchmark(
                lambda: mms_qa_apply(params, state, batch, cfg,
                                     train=False)[0]["logits"],
                iters=args.iters)
        # a whole train step: forward, backward and the AdaDelta update
        tr = Trainer(cfg, TrainerConfig(batch_size=args.batch),
                     device=device)
        tparams, tstate, topt = tr.init()
        train_full = benchmark(
            lambda: tr._train_step(tparams, tstate, topt, batch, 0)[3],
            iters=args.iters)
        scan_ms = None
        if args.fused_steps > 1:
            # K steps through scan_train_steps, per step: one dispatch, as
            # in the JAX package (on the card one CUDA graph replay, its
            # capture in the warm-up calls; on the CPU K eager steps)
            k = args.fused_steps
            stacked = {kk: torch.stack([v] * k) for kk, v in batch.items()}
            scan_full = benchmark(
                lambda: tr.scan_train_steps(tparams, tstate, topt, stacked,
                                            0)[3][-1],
                iters=max(2, args.iters // 4))
            scan_ms = scan_full["p50_s"] * 1e3 / k
    table = {name: {"forward_ms": round(r["forward_ms"], 4),
                    "backward_ms": round(r["backward_ms"], 4)}
             for name, r in stages.items()}
    out = {"batch": args.batch, "p50_ms_per_stage": table,
           "full_forward_ms": round(full["p50_s"] * 1e3, 4),
           "full_train_step_ms": round(train_full["p50_s"] * 1e3, 4),
           "note": "stage times are each stage alone, timed by CUDA events "
                   "over a burst (backward: autograd of the stage's "
                   "output); full_forward / full_train_step are host "
                   "p50s of whole calls; fused_train_step is one "
                   "scan_train_steps call of K steps (on the card one "
                   "CUDA graph replay, captured in the warm-up) per "
                   "step"}
    if scan_ms is not None:
        out["fused_train_step_ms"] = round(scan_ms, 4)
        out["fused_steps"] = args.fused_steps
    if args.xprof:
        out["xprof"] = args.xprof
    print(json.dumps(out))


# --------------------------------------------------------------------- plot
_PLOT_TYPES = [  # tools/extra/plot_training_log.py.example:41-52's order
    ("Test accuracy", "Iters"), ("Test accuracy", "Seconds"),
    ("Test loss", "Iters"), ("Test loss", "Seconds"),
    ("Train learning rate", "Iters"),
    ("Train learning rate", "Seconds"),
    ("Train loss", "Iters"), ("Train loss", "Seconds"),
]


def plot_series(chart_type: int, logs) -> list:
    """[(label, xs, ys)] that ``plot`` draws: one series a log."""
    from .utils.parse_log import parse_log

    y_desc, x_desc = _PLOT_TYPES[chart_type]
    split = y_desc.split()[0].lower()     # train / test rows
    x_col = "NumIters" if x_desc == "Iters" else "Seconds"

    def y_value(row):
        if "learning rate" in y_desc:
            return row.get("LearningRate")
        want = y_desc.split()[1]          # accuracy / loss
        if want in row:
            return row[want]
        for k in row:                      # accuracy matches acc/accuracy
            if k not in ("NumIters", "Seconds", "LearningRate") \
                    and k.startswith(want[:3]):
                return row[k]
        return None

    series = []
    for log_path in logs:
        with open(log_path) as f:
            train, test = parse_log(f.read())
        rows = train if split == "train" else test
        pts = [(r.get(x_col), y_value(r)) for r in rows]
        pts = [(x, y) for x, y in pts if x is not None and y is not None]
        if not pts:
            raise SystemExit(
                f"{log_path}: no ({x_desc}, {y_desc}) points — check the "
                f"log has {split} display lines"
                + (" with glog timestamps" if x_col == "Seconds" else ""))
        xs, ys = zip(*pts)
        series.append((os.path.basename(log_path), list(xs), list(ys)))
    return series


def cmd_plot(args):
    """tools/extra/plot_training_log.py.example: chart_type [0-7] +
    parsed training logs -> a PNG of learning curves, one line per log.
    matplotlib is imported here only; without it the command exits with
    a message and draws nothing."""
    if args.chart_type is None or not args.out or not args.logs:
        for i, (y, x) in enumerate(_PLOT_TYPES):
            print(f"{i}: {y}  vs. {x}")
        return
    if not 0 <= args.chart_type < len(_PLOT_TYPES):
        raise SystemExit(
            f"chart_type {args.chart_type} out of range; supported:\n" +
            "\n".join(f"  {i}: {y} vs {x}"
                       for i, (y, x) in enumerate(_PLOT_TYPES)))
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("plot needs matplotlib, which this Python does not "
                         "have; nothing was drawn") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y_desc, x_desc = _PLOT_TYPES[args.chart_type]
    series = plot_series(args.chart_type, args.logs)
    plt.figure()
    for label, xs, ys in series:
        plt.plot(xs, ys, marker=".", label=label)
    plt.xlabel(x_desc)
    plt.ylabel(y_desc)
    plt.title(f"{y_desc} vs. {x_desc}")
    plt.legend()
    plt.savefig(args.out)
    plt.close()
    print(f"wrote {args.out}")


# ---------------------------------------------------------------- matbridge
def cmd_matbridge(args):
    """matcaffe bridge daemon: serves the MEX command surface
    (matlab/+caffe/private/caffe_.cpp) over line-delimited JSON, so the
    shipped matlab/+caffe .m client drives this package without a MEX
    build.  Blocks until a client sends {"cmd": "shutdown"}."""
    from .matcaffe import MatBridge, serve_matcaffe
    srv, port = serve_matcaffe(args.host, args.port, MatBridge(
        device=args.device), background=True)
    print(json.dumps({"matbridge": {"host": args.host, "port": port}}),
          flush=True)
    try:
        srv._stop.wait()
    except KeyboardInterrupt:
        pass
    srv.shutdown()
    srv.server_close()


# --------------------------------------------------------------------- main
def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch paths)")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(prog="mms_answer_selection_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prep",
                       help="TREC-QA XML / WikiQA TSV + vectors -> arrays")
    p.add_argument("--format", default="trec", choices=["trec", "wikiqa"])
    p.add_argument("--train-xml", required=True,
                   help="train split (XML for trec, TSV for wikiqa)")
    p.add_argument("--dev-xml", required=True)
    p.add_argument("--test-xml", required=True)
    p.add_argument("--glove", required=True)
    p.add_argument("--dim", type=int, default=50)
    p.add_argument("--q-len", type=int, default=40)
    p.add_argument("--a-len", type=int, default=40)
    p.add_argument("--out", required=True)
    p.add_argument("--hdf5", action="store_true",
                   help="also write reference-compatible HDF5 chunk files "
                        "(needs h5py)")
    p.add_argument("--mmsp", action="store_true",
                   help="also write the packed train.mmsp store for "
                        "`train --stream`")
    p.set_defaults(fn=cmd_prep)

    p = sub.add_parser("train", help="train + early stop + trec_eval score")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--config", help="experiment config json")
    p.add_argument("--mesh-dp", type=int, default=0,
                   help="data-parallel over N ranks, one device each (-1 = "
                        "all; the `caffe train -gpu 0,1,..` analogue)")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iterations (default 40001; overrides --config's "
                        "max_iter when given)")
    p.add_argument("--resume", nargs="?", const="auto",
                   help="resume training from a checkpoint dir (default: "
                        "latest under <exp>/models) -- `caffe train "
                        "-snapshot`")
    p.add_argument("--weights",
                   help="finetune: partial-load params from a checkpoint "
                        "by name+shape -- `caffe train -weights`")
    p.add_argument("--stream", action="store_true",
                   help="train from a batch stream (the MMSP packed store "
                        "via the C++ prefetch ring when <data>/train.mmsp "
                        "exists, else an in-memory iterator)")
    p.add_argument("--fused-steps", type=int, default=1,
                   help="up to K steps a chunk (scan_train_steps; on the "
                        "card one CUDA graph replay); chunks end at eval "
                        "and snapshot steps")
    p.add_argument("--solver-prototxt",
                   help="use a reference solver.prototxt for the "
                        "optimization and loop settings (--max-iter "
                        "overrides its max_iter)")
    p.add_argument("--net-prototxt",
                   help="use a reference train-net prototxt "
                        "(network_v3/v4/v4_2/v5 family) for the model")
    _device_flag(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint on a split")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--split", default="test")
    p.add_argument("--max-iter", type=int, default=40001)
    _device_flag(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("serve", help="index candidates + top-k retrieval")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--split", default="test")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--n-queries", type=int, default=5)
    p.add_argument("--int8", action="store_true",
                   help="int8 pool (half the bytes of bf16, ~1%% score "
                        "error)")
    p.add_argument("--pool-dtype", choices=["bf16", "int8", "int4"],
                   help="pool precision (int4: a quarter of bf16's bytes, "
                        "serve behind --rerank; overrides --int8)")
    p.add_argument("--rerank", type=int, default=0, metavar="SHORTLIST",
                   help="two-phase serve: kernel-shortlist this many "
                        "candidates, rescore them with the exact "
                        "interaction model, return top-k by P(correct)")
    p.add_argument("--max-iter", type=int, default=40001)
    p.add_argument("--listen", type=int, default=None, metavar="PORT",
                   help="run as a persistent HTTP retrieval service on "
                        "this port (0 = ephemeral; prints the bound "
                        "port) instead of the one-shot split scoring")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --listen (default loopback)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce concurrent requests that share "
                        "(k, rerank) into one device call, waiting up to "
                        "this long for peers (0 = off)")
    p.add_argument("--ivf-clusters", type=int, default=0,
                   help="build an IVF index over the pool so requests "
                        "can send 'shortlist' for the approximate "
                        "coarse-probe path (bf16 or int8 pools)")
    p.add_argument("--coarse-tokens", type=int, default=8,
                   help="token centroids per candidate for the IVF "
                        "coarse stage (1 = mean vector)")
    p.add_argument("--index", metavar="PATH",
                   help="persisted index file (.npz): load it if it "
                        "exists (warm restart, skips re-embedding and "
                        "re-clustering), else build then save it there")
    _device_flag(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("export",
                       help="freeze the eval forward + weights into one "
                            "torch.export deployment artifact")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic — "
                        "one program, any request size)")
    p.add_argument("--max-iter", type=int, default=40001)
    _device_flag(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("time",
                       help="per-stage fwd+bwd + whole-step timing")
    p.add_argument("--model",
                   help="time any net prototxt (caffe time --model; "
                        "needs deploy-style input_shape/input_dim or "
                        "Input-layer shape declarations)")
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--fused-steps", type=int, default=1,
                   help="also time K steps through scan_train_steps "
                        "(on the card one CUDA graph replay)")
    p.add_argument("--serve-pool", type=int, default=0, metavar="N",
                   help="instead: time the serve lifecycle on an "
                        "N-candidate synthetic pool (build/save/load/"
                        "query p50/add/remove/compact)")
    p.add_argument("--pool-dtype", choices=["bf16", "int8", "int4"],
                   help="pool precision for --serve-pool (default int8)")
    p.add_argument("--xprof", metavar="PATH",
                   help="also write a torch.profiler Chrome trace to PATH")
    _device_flag(p)
    p.set_defaults(fn=cmd_time)

    p = sub.add_parser("extract",
                       help="dump embeddings/probs for a split (npz)")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--split", default="test")
    p.add_argument("--out")
    p.add_argument("--max-iter", type=int, default=40001)
    _device_flag(p)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("saliency",
                       help="per-token |dLoss/dEmbedding| heatmaps")
    p.add_argument("--data", required=True)
    p.add_argument("--exp", required=True)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--split", default="test")
    p.add_argument("-n", type=int, default=8)
    p.add_argument("--out")
    p.add_argument("--max-iter", type=int, default=40001)
    _device_flag(p)
    p.set_defaults(fn=cmd_saliency)

    p = sub.add_parser("summarize",
                       help="model structure table + history CSV export")
    p.add_argument("--config")
    p.add_argument("--variant", default="v4",
                   choices=["v3", "v4", "v4_2", "v5"])
    p.add_argument("--history", help="history.json from a training run")
    p.set_defaults(fn=cmd_summarize)

    p = sub.add_parser(
        "parse_log",
        help="parse a caffe/solve training log into train/test CSVs")
    p.add_argument("log", help="log file (glog or `solve` output)")
    p.add_argument("--out-dir", help="directory for the CSVs "
                                     "(default: beside the log)")
    p.set_defaults(fn=cmd_parse_log)

    p = sub.add_parser(
        "reproduce",
        help="real-data parity gate: run the published TREC-QA recipe and "
             "assert the published MAP/MRR within tolerance")
    p.add_argument("--train-xml", required=True,
                   help="jacana train-all.xml")
    p.add_argument("--dev-xml", required=True)
    p.add_argument("--test-xml", required=True)
    p.add_argument("--glove", required=True, help="glove.6B.50d.txt")
    p.add_argument("--dim", type=int, default=50)
    p.add_argument("--q-len", type=int, default=40)
    p.add_argument("--a-len", type=int, default=40)
    p.add_argument("--out", default="runs/reproduce")
    p.add_argument("--max-iter", type=int, default=40001)
    p.add_argument("--fused-steps", type=int, default=1)
    p.add_argument("--expected-map", type=float, default=0.7793)
    p.add_argument("--expected-mrr", type=float, default=0.8487)
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="absolute band around the published numbers "
                        "(covers seed and hardware noise on one run)")
    _device_flag(p)
    p.set_defaults(fn=cmd_reproduce)

    p = sub.add_parser(
        "solve",
        help="generic `caffe train`: run any net prototxt through its "
             "solver prototxt (GraphNet + the reference solver loop)")
    p.add_argument("--solver", required=True,
                   help="solver.prototxt (net/train_net/test_net paths "
                        "resolve relative to it)")
    p.add_argument("--weights", help="init from .caffemodel[.h5] files, "
                                     "comma-separated")
    p.add_argument("--snapshot", help="resume from a .solverstate[.h5]")
    p.add_argument("--mesh-dp", type=int, default=0,
                   help="data-parallel over N ranks, one device each (-1 = "
                        "all; the `caffe train -gpu 0,1,..` analogue)")
    _device_flag(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser(
        "nettest",
        help="generic `caffe test`: score any net prototxt in TEST phase "
             "for N iterations (averaged output blobs)")
    p.add_argument("--model", required=True, help="net prototxt")
    p.add_argument("--weights", help=".caffemodel[.h5] to load")
    p.add_argument("--iterations", type=int, default=50)
    _device_flag(p)
    p.set_defaults(fn=cmd_nettest)

    p = sub.add_parser(
        "image_mean",
        help="compute_image_mean: the mean image over a list -> "
             "mean.binaryproto for transform_param mean_file")
    p.add_argument("list", help="pair list or `path label` list file")
    p.add_argument("--root", default="", help="image root folder")
    p.add_argument("--new-height", type=int, default=0)
    p.add_argument("--new-width", type=int, default=0)
    p.add_argument("--out", help="output .binaryproto (omit to print the "
                                 "channel means only)")
    p.set_defaults(fn=cmd_image_mean)

    p = sub.add_parser("convert",
                       help="weights <-> reference .caffemodel[.h5]")
    p.add_argument("--ckpt", help="our checkpoint dir (export source)")
    p.add_argument("--caffemodel",
                   help="reference-layout .caffemodel[.h5] (import source)")
    p.add_argument("--data", help="prepped data dir (import: model shapes)")
    p.add_argument("--config", help="experiment config json (import)")
    p.add_argument("--exp", help="experiment dir (import: saved config)")
    p.add_argument("--max-iter", type=int, default=40001)
    p.add_argument("--out", required=True,
                   help="output .caffemodel[.h5] (export) or checkpoint "
                        "dir (import)")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "draw",
        help="draw_net.py: net prototxt -> Graphviz DOT structure graph")
    p.add_argument("--net", required=True, help="net prototxt")
    p.add_argument("--phase", choices=["train", "test"],
                   help="filter include/exclude rules (default: all)")
    p.add_argument("--rankdir", default="LR",
                   choices=["LR", "TB", "RL", "BT"])
    p.add_argument("--out", help="output .dot path (default: stdout)")
    p.set_defaults(fn=cmd_draw)

    p = sub.add_parser(
        "convert_imageset",
        help="convert_imageset tool: `path label` list -> an LMDB / "
             "LevelDB of Datums for Data layers, or chunked HDF5 + list "
             "file for HDF5Data layers")
    p.add_argument("root", help="image root folder (prefixed to paths)")
    p.add_argument("listfile", help="`path label` rows")
    p.add_argument("out", help="output directory")
    p.add_argument("--shuffle", action="store_true",
                   help="randomly shuffle the order of images")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gray", action="store_true",
                   help="treat images as grayscale")
    p.add_argument("--resize-height", type=int, default=0)
    p.add_argument("--resize-width", type=int, default=0)
    p.add_argument("--name", default="data",
                   help="list file basename (data -> data.txt)")
    p.add_argument("--chunk-rows", type=int, default=100000)
    p.add_argument("--backend", default="hdf5",
                   choices=["hdf5", "lmdb", "leveldb"],
                   help="hdf5 (chunked HDF5 + list; needs h5py), lmdb or "
                        "leveldb (uint8 Datums in the reference's "
                        "convert_imageset DB formats)")
    p.set_defaults(fn=cmd_convert_imageset)

    p = sub.add_parser(
        "extract_features",
        help="extract_features tool: save named blobs over N TEST "
             "batches (one .npy per blob)")
    p.add_argument("--model", required=True,
                   help="net prototxt with data layers (TEST phase)")
    p.add_argument("--weights", help=".caffemodel[.h5] trained weights")
    p.add_argument("--blobs", required=True,
                   help="comma-separated blob names to extract")
    p.add_argument("--iterations", type=int, default=10,
                   help="num_mini_batches")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--seed", type=int, default=0)
    _device_flag(p)
    p.set_defaults(fn=cmd_extract_features)

    p = sub.add_parser(
        "upgrade",
        help="upgrade_net/solver_proto_text tools: legacy prototxt -> "
             "modern schema text")
    p.add_argument("input", help="net or solver prototxt (any era), or "
                                 "with --binary a binary NetParameter "
                                 "(.caffemodel)")
    p.add_argument("out", nargs="?", help="output path (stdout if "
                                          "omitted; required with "
                                          "--binary)")
    p.add_argument("--kind", default="auto",
                   choices=["auto", "net", "solver"])
    p.add_argument("--binary", action="store_true",
                   help="upgrade_net_proto_binary: input is a binary "
                        "NetParameter; writes binary, or structure-only "
                        "text when out ends in .prototxt")
    p.set_defaults(fn=cmd_upgrade)

    p = sub.add_parser(
        "classify",
        help="classify.py tool: images -> class-probability .npy via "
             "the Classifier wrapper")
    p.add_argument("input_file", help="image file, directory, or .npy "
                                      "stack of (H, W, K) images")
    p.add_argument("output_file", help="output .npy of predictions")
    p.add_argument("--model-def", required=True, help="deploy prototxt")
    p.add_argument("--pretrained-model",
                   help=".caffemodel[.h5] weights (random init if "
                        "omitted; for smoke tests only)")
    p.add_argument("--center-only", action="store_true",
                   help="center crop alone instead of 10-crop "
                        "oversampling")
    p.add_argument("--images-dim", default="256,256",
                   help="resize canvas H,W before cropping")
    p.add_argument("--mean-file",
                   help=".npy (CHW or per-channel) or mean.binaryproto")
    p.add_argument("--input-scale", type=float)
    p.add_argument("--raw-scale", type=float, default=255.0)
    p.add_argument("--channel-swap", default="2,1,0",
                   help="e.g. 2,1,0 maps RGB -> BGR")
    p.add_argument("--ext", default="jpg",
                   help="extension glob when input is a directory")
    _device_flag(p)
    p.set_defaults(fn=cmd_classify)

    p = sub.add_parser(
        "detect",
        help="detect.py tool: window CSV -> per-window class scores "
             "via the Detector wrapper")
    p.add_argument("input_file",
                   help="CSV with header filename,ymin,xmin,ymax,xmax")
    p.add_argument("output_file", help=".csv or .npz of detections")
    p.add_argument("--model-def", required=True, help="deploy prototxt")
    p.add_argument("--pretrained-model", help=".caffemodel[.h5] weights")
    p.add_argument("--crop-mode", default="list", choices=["list"],
                   help="selective_search needs the external MATLAB "
                        "package (same constraint as the reference)")
    p.add_argument("--context-pad", type=int, default=16)
    p.add_argument("--mean-file",
                   help=".npy or mean.binaryproto (collapsed to "
                        "per-channel like detect.py)")
    p.add_argument("--input-scale", type=float)
    p.add_argument("--raw-scale", type=float, default=255.0)
    p.add_argument("--channel-swap", default="2,1,0")
    _device_flag(p)
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("device_query", help="list the torch devices")
    _device_flag(p)
    p.set_defaults(fn=cmd_device_query)

    p = sub.add_parser(
        "plot",
        help="plot_training_log tool: chart_type [0-7] + logs -> "
             "learning-curve PNG (no args lists chart types)")
    p.add_argument("chart_type", nargs="?", type=int)
    p.add_argument("out", nargs="?", help="output .png")
    p.add_argument("logs", nargs="*", help="training log files")
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser(
        "matbridge",
        help="serve the matcaffe command surface to the matlab/+caffe "
             ".m client (line-delimited JSON over TCP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8491)
    _device_flag(p)
    p.set_defaults(fn=cmd_matbridge)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
