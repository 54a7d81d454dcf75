#!/usr/bin/env python3
"""Reads how far ``Trainer.fit_stream`` on the GPU parts from the same run
on the CPU, in the setup of ``tests/test_torch_cuda.py::
test_fit_stream_on_cuda_matches_cpu`` (V4 with a xavier W, vocabulary 500,
batch 50, dropout off, three steps from one packed file, dev evals after
steps 0 and 2 over 12 groups of 10).

    python3 tools/fit_stream_probe.py

For the embedding started from the ±0.08 fill alone and from vectors of
GloVe's scale (0.5 N(0, 1)), prints per eval: each device's dev MAP, the
largest card-vs-CPU difference of P(correct), and how many groups have
every positive-negative gap of the CPU's scores above twice that (the
groups whose AP the test holds).  Needs a CUDA device; prints the card's
name and power limit first.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mms_answer_selection_tpu_torch.models.mms_qa import MMSQAConfig  # noqa: E402
from mms_answer_selection_tpu_torch.native import (  # noqa: E402
    NativePrefetcher, PackedStore, write_mmsp)
from mms_answer_selection_tpu_torch.training import (  # noqa: E402
    SolverConfig, Trainer, TrainerConfig)

GROUPS, GROUP_SIZE, VOCAB = 12, 10, 500


class Recording(Trainer):
    """Keeps each eval's P(correct) on the host."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.probs = []

    def _eval_step(self, params, state, batch):
        res = super()._eval_step(params, state, batch)
        self.probs.append(res["prob"][:, 1].cpu().double().numpy())
        return res


def run(glove: bool, tmp: str) -> None:
    cfg = dataclasses.replace(MMSQAConfig(), vocab_size=VOCAB,
                              sim_weight_init="xavier", sim_dropout=0.0,
                              fc1_dropout=0.0)
    tcfg = TrainerConfig(solver=SolverConfig(), batch_size=50,
                         test_interval=2, train_loss_record_interval=1)
    rng = np.random.default_rng(5)          # the test's draws, in order

    def rows(n):
        return {"question": rng.integers(0, VOCAB, (n, 40)).astype(np.int32),
                "answer": rng.integers(0, VOCAB, (n, 40)).astype(np.int32),
                "overlap_feat": rng.random((n, 2)).astype(np.float32),
                "label": (rng.random(n) < 0.3).astype(np.int32)}

    path = str(Path(tmp) / "train.mmsp")
    write_mmsp(path, rows(300))
    groups = np.repeat(np.arange(GROUPS), GROUP_SIZE)
    dev_split = rows(GROUPS * GROUP_SIZE) | {"group": groups}
    labels = dev_split["label"]
    vectors = (0.5 * rng.standard_normal((VOCAB, 50))).astype(np.float32)
    hist, probs = {}, {}
    for where in ("cpu", "cuda"):
        ring = NativePrefetcher(PackedStore(path), ["question", "answer",
                                                    "label", "overlap_feat"],
                                50, seed=1)
        tr = Recording(cfg, tcfg, device=where)
        hist[where] = tr.fit_stream(ring, dev_split, steps=3,
                                    pretrained=vectors if glove else None)
        probs[where] = tr.probs
    for e, step in enumerate(hist["cpu"]["steps"]):
        p_cpu, p_card = probs["cpu"][e], probs["cuda"][e]
        diff = float(np.abs(p_card - p_cpu).max())
        gaps = [np.abs(p_cpu[(groups == g) & (labels == 1)][:, None]
                       - p_cpu[(groups == g) & (labels == 0)][None, :]).min()
                for g in range(GROUPS)]
        print(f"embedding {'GloVe-scale' if glove else '±0.08 fill'}, eval "
              f"after step {step}: dev MAP CPU {hist['cpu']['dev_map'][e]:.6f}"
              f" card {hist['cuda']['dev_map'][e]:.6f}; max |dP| {diff:.3e};"
              f" groups with no pair within 2 max |dP|: "
              f"{sum(g > 2 * diff for g in gaps)} of {GROUPS}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fit_stream_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for glove in (False, True):
            run(glove, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
