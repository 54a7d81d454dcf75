"""Training-history tooling, the tools/extra parse_log.py / summarize.py
analogues (counterpart of ``utils/history.py``, a copy).

The reference scrapes glog text logs back into CSV
(tools/extra/parse_log.py:17-30) and prints prototxt structure tables
(summarize.py).  This framework emits structured history.json directly from
the Trainer, so the tooling here just formats:

* ``history_to_csv`` -- train/test CSV rows compatible with what
  parse_log.py produced (iteration, seconds, loss / metric columns)
* ``summarize_model`` -- the layer-table printer: per-stage output shapes
  and parameter counts for an MMSQAConfig
"""

from __future__ import annotations

import io
import math


def history_to_csv(history: dict) -> tuple[str, str]:
    """Returns (train_csv, eval_csv)."""
    train = io.StringIO()
    train.write("NumIters,TrainingLoss\n")
    interval = history.get("train_loss_record_interval", 20)
    for i, loss in enumerate(history.get("train_loss", [])):
        train.write(f"{i * interval},{loss}\n")
    ev = io.StringIO()
    ev.write("NumIters,dev_map,dev_mrr,dev_auc,test_map,test_mrr,test_auc\n")
    steps = history.get("steps", [])
    for i, step in enumerate(steps):
        def g(key):
            vals = history.get(key, [])
            return vals[i] if i < len(vals) else ""
        ev.write(f"{step},{g('dev_map')},{g('dev_mrr')},{g('dev_auc')},"
                 f"{g('test_map')},{g('test_mrr')},{g('test_auc')}\n")
    return train.getvalue(), ev.getvalue()


def summarize_model(cfg) -> str:
    """Layer table: stage / output shape / #params for an MMSQAConfig."""
    rows = []
    n_params = 0

    def add(name, shape, params):
        nonlocal n_params
        n_params += params
        rows.append((name, "x".join(map(str, shape)), params))

    d = cfg.embed_dim
    add("embed", (cfg.question_len, d),
        cfg.vocab_size * d + d)
    h, w = cfg.question_len, cfg.answer_len
    c = cfg.sim_channels()
    if cfg.sim_mode == 2:
        sim_p = cfg.sim_measures * d * d
        if cfg.sim_bias:
            sim_p += cfg.sim_measures * h * w
        add(f"sim_cross(bilinear,M={cfg.sim_measures})", (h, w, c), sim_p)
    else:
        mode = "cosine" if cfg.sim_mode == 0 else "inv-euclidean"
        add(f"sim_cross({mode})", (h, w, 1), 0)
    in_ch = c
    for i, b in enumerate(cfg.blocks):
        h, w = h - b.kh + 1, w - b.kw + 1
        add(f"conv{i}({b.kh}x{b.kw})", (h, w, b.out_channels),
            b.kh * b.kw * in_ch * b.out_channels + b.out_channels)
        add(f"bn{i}", (h, w, b.out_channels), 2 * b.out_channels)
        h = int(math.ceil((h - b.pool_k) / b.pool_stride)) + 1
        w = int(math.ceil((w - b.pool_k) / b.pool_stride)) + 1
        add(f"pool{i}({b.pool},{b.pool_k})+tanh", (h, w, b.out_channels), 0)
        in_ch = b.out_channels
    flat = h * w * in_ch + cfg.overlap_features
    add("concat(overlap)", (flat,), 0)
    add("fc1+tanh", (cfg.fc1_dim,), flat * cfg.fc1_dim + cfg.fc1_dim)
    add("fc2", (cfg.num_classes,),
        cfg.fc1_dim * cfg.num_classes + cfg.num_classes)

    width = max(len(r[0]) for r in rows) + 2
    out = [f"{'stage':<{width}}{'output':<16}params"]
    for name, shape, params in rows:
        out.append(f"{name:<{width}}{shape:<16}{params}")
    out.append(f"{'TOTAL':<{width}}{'':<16}{n_params}")
    return "\n".join(out)
