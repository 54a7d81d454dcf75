"""The benchmark of ``mms_answer_selection_tpu_torch`` on NVIDIA H100s.

    python3 -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout.
The cell names a configuration (``configs/<name>.json``, found through
the ``configs`` entry's ``file``) and a traffic mix
(``traffic/<name>.json``); the mix's ``kind`` names the runner that runs
it (``runners/<kind>.py``).  With ``--trace 0`` the result line holds the
cell's end-to-end metrics; with ``--trace 1`` a device trace is taken and
the line holds the cell's per-layer metrics, each read by its own reader
``metrics/<name>.py`` (``read(run)`` returns a number, or None when the
run holds nothing for it).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with a trace
``breakdown``), and last ``checks``: each number compared for
``correct`` beside its limit, which the last lines of standard error
repeat.  Without CUDA, with fewer cards than the cell asks for, or with
``jax``, ``jaxlib``, ``flax`` or ``mms_answer_selection_tpu`` loaded once
the window has closed, it prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

from h100_bench import roofline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must never load, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "mms_answer_selection_tpu")


class Refused(Exception):
    """The run cannot measure here: no result, exit code 2."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Run:
    """One run of one cell: its inputs, and what the runner measured."""

    def __init__(self, spec: dict, workload: str, seed: int, seconds: float,
                 trace: bool, t0: float, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.root = Path(root)               # the checkout
        self.home = self.root / HERE.name    # the harness in it
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = read_json(self.root
                                / configs[self.cell["config"]]["file"])
        self.traffic = read_json(self.home / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.name, self.seed, self.seconds = workload, seed, seconds
        self.trace = trace
        self.t0 = t0                     # process start, on time.time()
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in moves)]
        self.device = None
        # filled by the runner
        self.setup_s = None
        self.e2e: dict = {}
        self.work: dict = {}
        self.counters: dict = {}
        self.device_trace = None
        self.attempted = self.failed = 0
        self.checks: dict = {}           # name -> (value, limit)
        self.memory_peak = 0
        self.extra_modules: list[str] = []   # forbidden names other ranks saw
        self.marks: dict = {}            # set-up stage -> seconds since t0

    def mark(self, stage: str) -> None:
        """Set-up's stages, on standard error at the end of the run."""
        self.marks[stage] = round(time.time() - self.t0, 3)

    def busy_s(self) -> float:
        """Device-busy seconds of the traced window, averaged over the
        cards the run used."""
        per_card = self.work.get("busy_s_by_rank") or [
            self.device_trace.busy_s]
        return sum(per_card) / len(per_card)

    def setup_done(self) -> float:
        """Marks the window's start; set-up is everything before it."""
        self.setup_s = time.time() - self.t0
        return self.setup_s

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())

    def compare(self, name: str, value: float, limits: dict) -> None:
        self.checks[name] = (float(value), float(limits[name]))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Refused(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(run: Run):
    """The runner of the run's traffic kind, ``runners/<kind>.py``."""
    kind = run.traffic["kind"]
    return load_module(run.home / "runners" / f"{kind}.py",
                       f"h100_bench.runners.{kind}")


def read_metric(name: str, run: Run):
    """Per-layer metric ``name``, read by ``metrics/<name>.py``."""
    mod = load_module(run.home / "metrics" / f"{name}.py",
                      "h100_bench.metrics." + name.replace(".", "_"))
    return mod.read(run)


def result(run: Run, device: dict) -> dict:
    metrics = {}
    if run.trace:
        for m in run.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.end_to_end:
            value = run.setup_s if m["name"] == "setup_s" \
                else run.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.trace and run.device_trace is not None:
        device = dict(device, busy_s=run.busy_s(),
                      window_s=run.device_trace.window_s)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.device_trace is not None:
        out["breakdown"] = run.device_trace.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in run.checks.items()}
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m h100_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell over several cards (runners/train.py starts them)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def environment() -> None:
    """Caches inside the checkout, at fixed paths; few host threads."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def main(argv=None, t0: float | None = None) -> int:
    args = parse(argv)
    t0 = args.t0 if args.t0 is not None else (t0 or time.time())
    environment()
    try:
        spec = read_json(ROOT / "BENCHMARK.json")
        run = Run(spec, args.workload, args.seed, args.seconds,
                  bool(args.trace), t0)
        import torch

        run.mark("torch imported")
        chips = int(run.cell["chips"])
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card "
                          "and never falls back to the CPU")
        if torch.cuda.device_count() < chips:
            raise Refused(f"{run.name} needs {chips} cards, "
                          f"{torch.cuda.device_count()} visible")
        torch.set_num_threads(4)
        kind_runner = runner(run)
        if args.rank is not None:
            return kind_runner.rank_main(run, args.rank, args.rank_out)
        kind_runner.execute(run)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": chips, "memory_peak_bytes": int(run.memory_peak),
                  "power_limit": roofline.card_power_limit()}
    except Refused as exc:
        print(f"h100_bench: {exc}", file=sys.stderr)
        return 2
    found = sorted(set(forbidden_modules()) | set(run.extra_modules))
    if found:
        print(f"h100_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 2
    out = result(run, device)
    trace = run.device_trace
    print(f"set-up stages (s since start): {run.marks}", file=sys.stderr)
    print(f"setup_s: {run.setup_s!r}; window: {run.work.get('window_s')!r} s"
          + (f"; trace parsed in {trace.parse_s:.1f} s" if trace else ""),
          file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for n, (v, lim) in run.checks.items():
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
