#!/usr/bin/env python3
"""Runs the JAX package's four recorded recipe-scale runs
(``docs/runs/recipe_scale_*``) through the port's twin on the card, each
with the JAX run's flags, and writes each run's artifacts with a README.

    python3 tools/recorded_runs.py --out DIR [--work WORK] [NAME ...]

Each run is the command a user types, in its own process:

    python -m mms_answer_selection_tpu_torch.examples.recipe_scale_rehearsal \\
        --out WORK/NAME FLAGS

Its ``summary.json``, ``history.json``, ``truth`` and ``result`` are
copied to ``DIR/NAME/`` (the snapshots under ``WORK/NAME/models`` stay
behind), with a ``README.md`` that gives the command, the card's name and
power limit, and the port's MAPs beside the JAX run's.  The committed
``DIR`` is ``docs/runs_torch``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TWIN = "mms_answer_selection_tpu_torch.examples.recipe_scale_rehearsal"
RUNS = {  # name -> the JAX run's flags (docs/runs/<name>/README.md)
    "recipe_scale_wide300": ("--model", "v4_wide"),
    "recipe_scale_wikiqa": ("--format", "wikiqa"),
    "recipe_scale_v4": ("--max-iter", "4001"),
    "recipe_scale_v4_hard": ("--hard", "--max-iter", "6001",
                             "--fused-steps", "100"),
}
FILES = ("summary.json", "history.json", "truth", "result")
# |best dev MAP - the JAX run's|, stated before the first card run
BAND = 0.02


def readme(name: str, flags, s: dict, jax: dict, torch_version: str) -> str:
    """The run's README: the command, the card, its MAPs beside JAX's."""
    def maps(x):
        return (f"{x['best_dev_map']:.4f} @ {x['best_step']:,}",
                f"{x['test_map']:.4f} / {x['test_mrr']:.4f}")

    def pairs(x):
        return " / ".join(f"{x['corpus'][k]:,}" for k in ("train", "dev",
                                                          "test"))

    ours, theirs = maps(s), maps(jax)
    gap = abs(s["best_dev_map"] - jax["best_dev_map"])
    caps = ", ".join(f"K = {c['k']}: {c['capture_s']:.3f} s, "
                     f"{c['pool_bytes'] / 2**20:.0f} MiB"
                     for c in s["dispatch"]["captures"])
    evals = s["eval_dispatch"]
    return f"""# {name} — the JAX package's `docs/runs/{name}` on the card

The JAX package's recorded run of `examples/recipe_scale_rehearsal.py
{' '.join(flags)}`, run through the port's twin with the same flags:

    python -m {TWIN} \\
      --out D {' '.join(flags)}

(`D` outside the repository; `tools/recorded_runs.py` ran the command and
copied `summary.json`, `history.json`, `truth` and `result` here, the
snapshots left behind.)

Card: {s['card']} (`nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`), torch {torch_version}.

| quantity | this run (`summary.json`) | the JAX package's run (`docs/runs/{name}/summary.json`) |
|---|---|---|
| model, format, embed_dim, max_iter | {s['model']}, {s['format']}, {s['embed_dim']}, {s['max_iter']} | {jax.get('model', 'v4')}, {jax.get('format', 'trec')}, {jax.get('embed_dim', 50)}, {jax['max_iter']} |
| corpus: train / dev / test pairs; vocab_size | {pairs(s)}; {s['vocab_size']:,} | {pairs(jax)}; {jax['vocab_size']:,} |
| dev MAP at step 0 (chance floor) | {s['chance_dev_map_step0']:.4f} | {jax['chance_dev_map_step0']:.4f} |
| best dev MAP @ step | {ours[0]} | {theirs[0]} |
| test MAP / MRR at the best-dev params | {ours[1]} | {theirs[1]} |
| `fit` wall, evals and snapshots included | {s['fit_s']} s | (taken on another accelerator; no reference here) |
| chunks, each one CUDA graph replay | {s['dispatch']['graph_replays']:,} ({caps}) | — |
| evals (dev and test), replays of {len(evals['captures'])} graphs | {evals['graph_replays']:,} | — |

Best dev MAP {gap:.4f} from the JAX run's: {'within' if gap <= BAND else 'outside'}
the band of {BAND} stated before the run (`CHANGES.md`). Pinned by
`tests/test_torch_examples_serving.py::test_recorded_run_card_artifact[{name}]`.
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--work", default=None,
                    help="where the runs write (snapshots included)")
    ap.add_argument("names", nargs="*", default=list(RUNS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("recorded_runs: no CUDA device", file=sys.stderr)
        return 2
    work = Path(args.work or tempfile.mkdtemp(prefix="recorded_runs_"))
    failed = []
    for name in args.names:
        flags = RUNS[name]
        cmd = [sys.executable, "-m", TWIN, "--out", str(work / name), *flags]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        print(json.dumps({"run": name, "rc": rc,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        if rc:
            failed.append(name)
            continue
        dst = Path(args.out) / name
        dst.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            shutil.copy(work / name / f, dst / f)
        s = json.loads((dst / "summary.json").read_text())
        jax = json.loads((ROOT / "docs" / "runs" / name / "summary.json")
                         .read_text())
        (dst / "README.md").write_text(readme(name, flags, s, jax,
                                              torch.__version__))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
