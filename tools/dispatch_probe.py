#!/usr/bin/env python3
"""Times ``Trainer.fit`` on the GPU with this tree's dispatch (each chunk
one CUDA graph replay) against an earlier tree's, in turns.

    python3 tools/dispatch_probe.py --before DIR

``DIR`` holds another checkout of the repository (for example ``git
archive <commit> | tar -x -C DIR``).  Each side runs in its own process
(both packages have one name), in the order before, this, this, before;
each builds its kernels into its own tree, makes ``chip_smoke``'s
recipe-sized corpus and runs ``chip_smoke.train_phase``'s fit (V4, the
recipe's AdaDelta, batch 50, 301 steps, dev and test evals every 100)
once at ``steps_per_dispatch`` 1 and once at 50, each after a 3-step
warm-up fit.  Prints one JSON line per process and a summary line with
the mean wall of each side's two turns.  Needs a CUDA device; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KS = (1, 50)


def one_side(root: str) -> dict:
    """The fit walls of the tree at ``root`` (run in a child process)."""
    import dataclasses

    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs
    from mms_answer_selection_tpu_torch.models.mms_qa import V4
    from mms_answer_selection_tpu_torch.ops import _build
    from mms_answer_selection_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    splits, info, _ = cs.recipe_corpus(cs.D)
    tcfg = cs.recipe_trainer()
    model = dataclasses.replace(V4, vocab_size=info["vocab_size"])
    out = {"root": root}
    for k in KS:
        warm = Trainer(model, dataclasses.replace(tcfg, max_iter=3),
                       device="cuda")
        warm.fit(splits["train"], splits["dev"], test_data=splits["test"],
                 pretrained=info["pretrained"], steps_per_dispatch=k)
        tr = Trainer(model, tcfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.fit(splits["train"], splits["dev"],
                      test_data=splits["test"], pretrained=info["pretrained"],
                      steps_per_dispatch=k)
        torch.cuda.synchronize()
        out[f"fit_s_k{k}"] = time.perf_counter() - t0
        out[f"dev_map_k{k}"] = hist["dev_map"]
        runner = getattr(tr, "runner", None)
        out[f"replays_k{k}"] = None if runner is None else runner.replays
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", help="a checkout of the earlier tree")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(one_side(args.side)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    before, this = str(Path(args.before).resolve()), str(ROOT)
    runs = []
    for root in (before, this, this, before):
        res = subprocess.run([sys.executable, __file__, "--side", root],
                             capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {side: {f"fit_s_k{k}": sum(r[f"fit_s_k{k}"] for r in runs
                                         if r["root"] == root) / 2
                      for k in KS}
               for side, root in (("before", before), ("this", this))}
    print(json.dumps({"card": card, "fit_steps": 301, "batch": 50,
                      "mean_of_two_turns": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
