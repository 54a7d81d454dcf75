"""Image-pair metric learning (twin of ``examples/pair_image_metric.py``:
the reference's multimodal path, PairImageData + PairRankLoss +
RankAccuracy) on a synthetic corpus.

The model is a conv encoder under ``PairRankLoss``: it calls no pair map,
so this example launches none of the port's kernels.  The JAX script's
``jax.jit`` step becomes autograd and the port's ``make_solver``; the
dataset's order and the init are drawn from explicit seeds.

    python -m mms_answer_selection_tpu_torch.examples.pair_image_metric \\
        [--pairs 64] [--steps 60]

``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "pair_corpus"))
    return ap.parse_args(argv)


def main(argv=None, *, device=None) -> dict:
    args = parse_args(argv)

    import torch

    from ..data.pair_image import (PairImageDataset, compute_image_mean,
                                   synthetic_pair_corpus)
    from ..device import resolve_device
    from ..models.mms_qa import ConvBlock
    from ..models.pair_image import (PairImageConfig, pair_image_apply,
                                     pair_image_init)
    from ..training import SolverConfig, make_solver
    from ..utils.tree import tree_leaves, tree_map

    dev = resolve_device(device)
    lf = synthetic_pair_corpus(args.dir, n_pairs=args.pairs, hw=16, seed=1)
    mean = compute_image_mean(lf, root=args.dir)
    ds = PairImageDataset(lf, batch_size=16, root=args.dir, seed=2,
                          mean=mean)

    cfg = PairImageConfig(height=16, width=16, channels=1,
                          blocks=(ConvBlock(3, 3, 8, "max", 2, 2),
                                  ConvBlock(3, 3, 16, "max", 2, 2)),
                          fc_dim=16)
    params, state = pair_image_init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    solver = make_solver(SolverConfig(solver_type="adadelta"))
    opt_state = solver.init(params)

    def step(params, state, opt_state, batch, it):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        feed = iter(leaves)
        live = tree_map(lambda _: next(feed), params)
        out, new_state = pair_image_apply(live, state, batch, cfg,
                                          train=True)
        grads = torch.autograd.grad(out["loss"], leaves)
        g = iter(grads)
        params, opt_state = solver.apply(
            params, tree_map(lambda _: next(g), params), opt_state, it)
        return (params, new_state, opt_state, out["loss"].detach(),
                out["rank_accuracy"].detach())

    log = {"step": [], "loss": [], "rank_acc": []}
    for i in range(args.steps):
        raw = next(ds)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()
                 if k in ("img1", "img2", "label")}
        params, state, opt_state, loss, acc = step(params, state, opt_state,
                                                   batch, i)
        if i % 10 == 0:
            log["step"].append(i)
            log["loss"].append(float(loss))
            log["rank_acc"].append(float(acc))
            print(f"step {i}: loss {float(loss):.4f} "
                  f"rank_acc {float(acc):.3f}")
    print("done")
    return {**log, "final_loss": float(loss), "device": dev.type}


if __name__ == "__main__":
    main()
