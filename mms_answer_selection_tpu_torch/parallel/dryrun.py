"""A dry run of the multi-device paths on tiny shapes: the port's twin of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` starts ``n`` processes (``parallel.launch``), one
device each, over gloo.  Together they take one full sharded training step
(forward, backward, AdaDelta, BN state) over a (dp, tp) mesh, tp = 2 when
``n`` is even, and serve a candidate pool split over all ``n`` ranks:
bf16 unchunked and chunked, int8, and the int8 shortlist reranked by the
full model.  Each result is checked on every rank; a failure raises.

    python -c "from mms_answer_selection_tpu_torch.parallel.dryrun import \\
dryrun_multichip; dryrun_multichip(2)"
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _example_batch(n, cfg, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    batch = {
        "question": rng.integers(0, cfg.vocab_size, (n, cfg.question_len)),
        "answer": rng.integers(0, cfg.vocab_size, (n, cfg.answer_len)),
        "overlap_feat": rng.random((n, cfg.overlap_features)).astype(
            np.float32),
        "label": rng.integers(0, 2, (n,)),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _dryrun_rank(n_devices: int, device: str) -> dict:
    import torch.distributed as dist

    from ..models.mms_qa import ConvBlock, MMSQAConfig, mms_qa_init, \
        param_spec
    from ..serve import QueryEngine
    from ..training.optim import SolverConfig, make_solver
    from . import build_sharded_train_step, make_mesh, params_pspec, \
        shard_pytree
    from .mesh import mesh_shape

    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(tp=tp, devices=device)
    dev = torch.device(device) if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    cfg = MMSQAConfig(
        vocab_size=64, embed_dim=16, question_len=12, answer_len=12,
        sim_measures=2,
        blocks=(ConvBlock(3, 3, 8, "ave", 2, 2),
                ConvBlock(3, 3, 8, "ave", 3, 1)),
        fc1_dim=8)
    full, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(0),
                              device=dev)
    params = shard_pytree(full, mesh, params_pspec(full, mesh))
    solver = make_solver(
        SolverConfig(solver_type="adadelta", base_lr=1.0, momentum=0.95,
                     delta=5e-7, weight_decay=5e-4),
        param_spec(params, cfg))
    opt_state = solver.init(params)
    step = build_sharded_train_step(cfg, solver, mesh)(params, state,
                                                       opt_state)
    batch = _example_batch(4 * mesh_shape(mesh)["dp"], cfg, seed=1,
                           device=dev)
    params, state, opt_state, loss = step(
        params, state, opt_state, batch, 0,
        torch.Generator(device=dev).manual_seed(1))
    out = {"loss": float(loss)}

    # serve: the pool split over all n ranks, per-rank top-k, merged
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                     (2, cfg.question_len)), device=dev)
    cand = rng.integers(0, cfg.vocab_size, (n_devices * 128,
                                            cfg.answer_len))
    big = rng.integers(0, cfg.vocab_size, (n_devices * 128 * 2 + 40,
                                           cfg.answer_len))
    for name, pool, kw in (("bf16", cand, {}),
                           ("bf16_chunked", big, {"chunk_size": 128}),
                           ("int8", cand, {"pool_dtype": "int8"})):
        eng = QueryEngine(full, cfg, mesh=mesh, device=dev,
                          **kw).build_index(pool)
        vals, idx = eng.query(q, k=5)
        out[name] = (vals.cpu(), idx.cpu(), len(pool))
        if name == "int8":
            rv, ri = eng.query_rerank(state, q, k=3, shortlist=16)
            out["rerank"] = (rv.cpu(), ri.cpu(), len(pool))
    out["rank"] = dist.get_rank()
    return out


def dryrun_multichip(n_devices: int, *, device: str = "cpu",
                     timeout: float = 300.0) -> None:
    """One sharded train step and the sharded serve path on ``n_devices``
    ranks; raises if any rank fails or any result is off."""
    from .launch import spawn

    results = spawn("mms_answer_selection_tpu_torch.parallel.dryrun:"
                    "_dryrun_rank", n_devices,
                    kwargs={"n_devices": n_devices, "device": device},
                    timeout=timeout, share_device=device == "cpu")
    first = results[0]
    for r in results:
        assert math.isfinite(r["loss"]), "multichip train step gave NaN loss"
        assert r["loss"] == first["loss"], "ranks disagree on the loss"
        for name in ("bf16", "bf16_chunked", "int8", "rerank"):
            vals, idx, n = r[name]
            assert torch.isfinite(vals).all() and idx.max() < n, \
                f"multichip {name} serve gave a bad top-k"
            assert torch.equal(idx, first[name][1]), \
                f"ranks disagree on the {name} top-k"
