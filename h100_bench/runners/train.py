"""Recipe training throughput: ``Trainer.fit`` as ``cli train
--fused-steps K`` runs it, on one card or data-parallel over ``ranks``
cards (``Trainer(mesh=)`` over NCCL, as ``cli train --mesh-dp N`` runs it
under a launcher).

Set-up makes the corpus from the seed (``traffic.corpus``) and starts
``fit``, whose own seed is the run's: it initialises the weights, runs
step 0 as a one-step chunk and the dev eval at step 0, then the K-step
chunks to step ``warm_steps`` and its eval, capturing every graph the
window replays on the way.  ``fit``'s callback, called after each eval,
marks the window's start at the eval of step ``warm_steps`` and, at the
first eval after ``--seconds`` have passed, asks ``fit`` to stop there
with SIGINT, the stop its ``handle_signals`` contract gives (on several
ranks every rank stops at the same eval: rank 0's decision is broadcast):

    rate = (last step - warm_steps) x global batch /
           (time of the last eval's callback - start)

reported under the mix's ``rate_metric`` (``train_samples_per_s``; the
four-card cell's own name, whose runs spread wider, has its own bound).

The window holds the recipe's dev evals, every ``test_interval`` steps.

The first steps are the set-up's, through the window's own call (the
chunk replays): the callback at step 0 keeps the state after step 0,
and the first K-step chunk (steps 1..K) is observed once, its losses and
its carry kept.  After the window the reference follows the same
``follow_steps`` = K + 1 steps from the seed (``reference/plain.py``),
and ``judge.training`` compares the first losses, the first gradient
and the change over the followed steps.
"""

from __future__ import annotations

import gc
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time

import torch

from h100_bench import judge, port, traffic
from h100_bench.reference import plain
from h100_bench.trace import Tracer

RANK_TIMEOUT_S = 330


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """``fit``'s callback: the state machine of set-up, window and stop."""

    def __init__(self, run, trainer, mesh=None):
        self.run, self.trainer, self.mesh = run, trainer, mesh
        tr = run.traffic
        self.warm = int(tr["warm_steps"])
        self.trace_steps = int(tr["trace_steps"])
        self.tracer = Tracer() if run.trace else None
        self.kept: dict = {}
        self.t0 = self.t_end = None
        self.step_end = None
        self.launches0 = self.launches = None
        self.traced_steps = None
        self.evals_at: list[float] = []  # host clock at each window eval

    def _keep_first_chunk(self) -> None:
        """Observe the chunk of steps 1..K once: its losses and the carry
        after it (copies); then the runner is left as it was."""
        runner = self.trainer.runner

        def run_once(batches, step0, **kw):
            losses = type(runner).run(runner, batches, step0, **kw)
            if step0 == 1:
                self.kept["chunk"] = (losses.clone(), runner.snapshot())
                del runner.run
            return losses

        runner.run = run_once

    def _stop_now(self) -> bool:
        done = time.perf_counter() - self.t0 >= self.run.seconds
        if self.mesh is None:
            return done
        flag = torch.tensor([float(done)], device=self.run.device)
        torch.distributed.broadcast(flag, 0)
        return bool(flag.item())

    def __call__(self, info: dict) -> None:
        step = int(info["step"])
        if step == 0:
            self.run.mark("step 0 and its eval")
            self.kept["loss0"] = float(info["loss"])
            self.kept["after0"] = self.trainer.runner.snapshot()
            self._keep_first_chunk()
            return
        if step == self.warm:
            from mms_answer_selection_tpu_torch.ops import \
                sim_cross_kernels as sk

            _sync(self.run.device)
            self.run.setup_done()
            self.launches0 = dict(sk.LAUNCH_COUNTS)
            if self.tracer:
                self.tracer.start()
            self.t0 = time.perf_counter()
            return
        if step < self.warm:
            return
        self.evals_at.append(time.perf_counter())
        stop = self._stop_now()
        if self.tracer and self.tracer.result is None \
                and (stop or step >= self.warm + self.trace_steps):
            from mms_answer_selection_tpu_torch.ops import \
                sim_cross_kernels as sk

            self.run.device_trace = self.tracer.stop()
            self.traced_steps = step - self.warm
            self.launches = {n: sk.LAUNCH_COUNTS[n] - c
                             for n, c in self.launches0.items()}
        if stop:
            self.t_end, self.step_end = time.perf_counter(), step
            signal.raise_signal(signal.SIGINT)


def fit(run, dev, mesh=None, ranks: int = 1):
    """Set-up and window; returns (the callback, the corpus, the
    trainer)."""
    from mms_answer_selection_tpu_torch.training.trainer import Trainer

    cfg, tr = run.config, run.traffic
    shapes = dict(tr, vocab_size=cfg["vocab_size"])
    data = traffic.corpus(run.seed, shapes, dev)
    run.mark("corpus made")
    batch = int(tr["batch"]) * ranks
    trainer = Trainer(port.model_config(cfg),
                      port.trainer_config(cfg, tr, run.seed, batch),
                      device=dev, mesh=mesh)
    win = Window(run, trainer, mesh)
    history = trainer.fit(data["train"], data["dev"], callback=win,
                          handle_signals=True,
                          steps_per_dispatch=int(tr["steps_per_dispatch"]))
    if win.t_end is None:
        raise RuntimeError(f"fit ended at max_iter before the window closed "
                           f"({tr['max_iter']} steps)")
    steps = win.step_end - win.warm
    window_s = win.t_end - win.t0
    recorded = history["train_loss"]
    every = trainer.cfg.train_loss_record_interval
    in_window = recorded[win.warm // every + 1:win.step_end // every + 1]
    run.attempted = steps
    # a loss is recorded every ``every`` steps: a non-finite one counts
    # its span of steps as failed
    run.failed = every * sum(not math.isfinite(x) for x in in_window)
    run.e2e[tr["rate_metric"]] = steps * batch / window_s
    traced = win.traced_steps
    run.work = {"steps": steps, "window_s": window_s, "global_batch": batch,
                "local_batch": int(tr["batch"]), "ranks": ranks,
                "evals": steps // int(tr["test_interval"]),
                "dev_rows": len(data["dev"]["label"]),
                "traced_steps": traced,
                "traced_evals": None if traced is None
                else traced // int(tr["test_interval"])}
    run.counters = win.launches or {}
    _report_intervals(win, int(tr["test_interval"]))
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    return win, data, trainer


def _report_intervals(win, every: int) -> None:
    """The window's periods between evals (``every`` steps and an eval
    each) on standard error: their quantiles, and the share of the window
    the periods above the fastest took beyond it."""
    at = [win.t0] + win.evals_at
    ms = sorted(1e3 * (b - a) for a, b in zip(at, at[1:]))
    if not ms:
        return
    q = [ms[min(len(ms) - 1, int(f * len(ms)))] for f in (0.1, 0.5, 0.9)]
    excess = sum(m - ms[0] for m in ms) / sum(ms)
    print(f"periods of {every} steps: n {len(ms)}, min {ms[0]:.3f}, "
          f"p10 {q[0]:.3f}, p50 {q[1]:.3f}, p90 {q[2]:.3f}, "
          f"max {ms[-1]:.3f} ms; beyond the fastest {100 * excess:.2f}% "
          f"of the window", file=sys.stderr)


def check(run, win, data, ranks: int) -> None:
    """The first steps against the reference's."""
    tr, cfg = run.traffic, run.config
    follow = int(tr["steps_per_dispatch"]) + 1
    chunk_losses, carry = win.kept["chunk"]
    losses = [win.kept["loss0"]] + chunk_losses.tolist()
    g_first = judge.grad_norms(plain.leaves(win.kept["after0"][2]["h"]),
                               cfg["solver"]["momentum"])
    params = plain.leaves(carry[0])
    del win.kept
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = plain.train(cfg, cfg["solver"], run.seed, data["train"],
                      int(tr["batch"]) * ranks, follow, run.device)
    readings = judge.training(losses, g_first, params, ref,
                              int(tr["check_losses"]))
    for name, value in readings.items():
        run.compare(name, value, tr["limits"])


def measure(run, dev, mesh=None, ranks: int = 1, judge_it: bool = True):
    win, data, trainer = fit(run, dev, mesh, ranks)
    del trainer
    gc.collect()
    if judge_it:
        check(run, win, data, ranks)


def execute(run) -> None:
    ranks = int(run.traffic.get("ranks", 1))
    if ranks > 1:
        launch(run, ranks)
        return
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run.device = dev
    measure(run, dev)


# ------------------------------------------------------------ several cards
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(run, ranks: int) -> None:
    """Start one process a rank (``--rank r``), as a launcher starts
    ``cli train --mesh-dp N``; wait for every one; take rank 0's record."""
    out_dir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                           f"h100_bench_ranks_{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(ranks))
    procs = []
    for r in range(ranks):
        cmd = [sys.executable, "-m", "h100_bench", "--workload", run.name,
               "--seed", str(run.seed), "--seconds", str(run.seconds),
               "--trace", str(int(run.trace)), "--rank", str(r),
               "--rank-out", os.path.join(out_dir, f"rank{r}.json"),
               "--t0", repr(run.t0)]
        procs.append(subprocess.Popen(
            cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    deadline = time.time() + RANK_TIMEOUT_S
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    records = []
    for r in range(ranks):
        path = os.path.join(out_dir, f"rank{r}.json")
        with open(path, encoding="utf-8") as f:
            records.append(json.load(f))
        os.remove(path)
    os.rmdir(out_dir)
    rec = records[0]
    run.setup_s = rec["setup_s"]
    run.e2e = rec["e2e"]
    run.attempted, run.failed = rec["attempted"], rec["failed"]
    run.checks = {n: tuple(v) for n, v in rec["checks"].items()}
    run.memory_peak = max(r["memory_peak"] for r in records)
    run.extra_modules = sorted({m for r in records for m in r["modules"]})
    run.work, run.counters = rec["work"], rec["counters"]
    if run.trace and rec["trace"]:
        from h100_bench.trace import DeviceTrace
        run.device_trace = DeviceTrace(**rec["trace"])
        run.work["busy_s_by_rank"] = [r["trace"]["busy_s"] for r in records]


def rank_main(run, rank: int, out: str) -> int:
    """One rank of a cell over several cards: joins the group from the
    launcher's environment, runs ``fit`` over the dp mesh; every rank
    takes its trace, rank 0 the check; each writes its record to
    ``out``."""
    from mms_answer_selection_tpu_torch.parallel.mesh import make_mesh
    from mms_answer_selection_tpu_torch.parallel.multihost import initialize

    ranks = int(run.traffic["ranks"])
    initialize()
    if torch.cuda.is_available():
        mesh = make_mesh(ranks, 1)
        dev = torch.device("cuda", torch.cuda.current_device())
    else:                     # a rehearsal on the CPU over gloo
        mesh = make_mesh(ranks, 1, devices="cpu")
        dev = torch.device("cpu")
    run.device = dev
    measure(run, dev, mesh, ranks, judge_it=rank == 0)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    from h100_bench.run import forbidden_modules

    tr = run.device_trace
    record = {"setup_s": run.setup_s, "e2e": run.e2e,
              "attempted": run.attempted, "failed": run.failed,
              "checks": run.checks, "memory_peak": int(run.memory_peak),
              "modules": forbidden_modules(), "work": run.work,
              "counters": run.counters,
              "trace": None if tr is None else {
                  "window_s": tr.window_s, "busy_s": tr.busy_s,
                  "kernel_s": tr.kernel_s, "kernel_n": tr.kernel_n,
                  "gaps": tr.gaps,
                  "parse_s": tr.parse_s, "union_s": tr.union_s}}
    with open(out, "w", encoding="utf-8") as f:
        json.dump(record, f)
    return 0
