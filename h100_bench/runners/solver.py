"""``caffe train`` throughput: a layer-graph net's solver prototxt through
the program's ``GraphSolver``, as ``cli solve`` (``caffe train
--solver=...``) runs it, on one card, fed by its ``Data`` layer from an
LMDB of raw Datums.

Set-up, in a temporary directory outside the checkout (deleted at the
end): the database of ``train_images`` seeded 256 x 256 x 3 uint8 Datums
with labels uniform over the classes, written under the name the net's
TRAIN Data layer reads, beside verbatim copies of the configuration's
``solver.prototxt`` and ``train_val.prototxt``.  The solver is built from
that solver file and the run's seed, which seeds its feed and its dropout
generators; its initial weights are the plain reference's, drawn from the
seed (``reference/googlenet.py``), loaded in place of its own fillers'.
Then ``follow`` iterations one ``step`` at a time (their losses, the SGD
history after the first and the weights after the last are kept) and
``step`` to ``warm_steps``: every graph the window replays is captured.

The window is one ``step`` call, polled before each iteration through its
``action_fn`` (the signal poll of ``caffe train``), which stops it at the
first iteration after ``--seconds``:

    rate = iterations x batch / (time of that poll - start)

reported under the mix's ``rate_metric``.  With a trace the profiler runs
over the window's first ``trace_steps`` iterations.

The check, after the window: the reference follows the same ``follow``
iterations from the seed, on the images the database holds, and
``judge``'s comparisons read the first losses (the heads weighted), the
first gradient by leaf (from SGD's history: h = rate lr_mult (g + wd
decay_mult w) after one iteration) and the median leaf's change.
"""

from __future__ import annotations

import gc
import math
import os
import re
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from h100_bench import judge, traffic
from h100_bench.reference import googlenet as reference
from h100_bench.trace import Tracer

IMAGES = 11          # the stream tag of the database's images and labels


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- the data
def images(seed: int, count: int, classes: int, device):
    """(count, 3, 256, 256) uint8 and (count,) int64 labels, on the
    host: pixels uniform over 0..255, labels over the classes."""
    gen = traffic.generator(seed, IMAGES, device)
    side = reference.SIDE
    pixels = torch.randint(0, 256, (count, 3, side, side), generator=gen,
                           device=device, dtype=torch.uint8)
    labels = torch.randint(0, classes, (count,), generator=gen,
                           device=device)
    return pixels.cpu(), labels.cpu()


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def datum(chw: np.ndarray, label: int) -> bytes:
    """A caffe Datum's wire bytes: channels, height, width, the uint8
    pixels in (C, H, W) order, the label."""
    c, h, w = chw.shape
    data = chw.tobytes()
    return (b"\x08" + _varint(c) + b"\x10" + _varint(h) + b"\x18"
            + _varint(w) + b"\x22" + _varint(len(data)) + data + b"\x28"
            + _varint(label))


def write_database(path: str, pixels, labels) -> None:
    """The LMDB ``convert_imageset`` would write: keys %08d in order."""
    from mms_answer_selection_tpu_torch.utils.lmdb_io import write_lmdb

    arr, lab = pixels.numpy(), labels.tolist()
    write_lmdb(path, ((b"%08d" % i, datum(arr[i], lab[i]))
                      for i in range(len(lab))))


def _source(net_text: str) -> tuple[str, int]:
    """The TRAIN Data layer's source and batch size."""
    for layer in re.findall(r"layer\s*\{.*?\n\}", net_text, re.S):
        if re.search(r'type:\s*"Data"', layer) \
                and re.search(r"phase:\s*TRAIN", layer):
            return (re.search(r'source:\s*"([^"]+)"', layer).group(1),
                    int(re.search(r"batch_size:\s*(\d+)", layer).group(1)))
    raise ValueError("the net has no TRAIN Data layer")


def lay_out(run, tmp: str, pixels, labels) -> tuple[str, int]:
    """The solver's directory: the database under the net's source name,
    the two prototxts copied (a mix's ``batch``, which a rehearsal on the
    host sets, in place of the TRAIN batch_size); returns (the solver
    file, the batch)."""
    cfg = run.config
    net_path = run.root / cfg["net"]
    text = net_path.read_text()
    source, batch = _source(text)
    if "batch" in run.traffic:      # a rehearsal's smaller batch
        text = text.replace(f"batch_size: {batch}\n",
                            f"batch_size: {run.traffic['batch']}\n", 1)
        source, batch = _source(text)
    write_database(os.path.join(tmp, source), pixels, labels)
    with open(os.path.join(tmp, net_path.name), "w") as f:
        f.write(text)
    solver = os.path.join(tmp, "solver.prototxt")
    shutil.copy(run.root / cfg["solver"], solver)
    return solver, batch


# ------------------------------------------------------- weights and state
def to_program(params: dict) -> dict:
    """The reference's Caffe-layout weights in the program's layout:
    convolutions HWIO, inner products (in, out) with ``in`` in the
    (H, W, C) order of an NHWC blob."""
    out = {}
    for name, leaf in params.items():
        w = leaf["w"]
        if w.ndim == 4:
            w = w.permute(2, 3, 1, 0)
        else:
            c, h, wd = reference.FC_IN[name]
            w = w.reshape(w.shape[0], c, h, wd).permute(2, 3, 1, 0) \
                .reshape(h * wd * c, w.shape[0])
        out[name] = {"w": w.contiguous(), "b": leaf["b"].clone()}
    return out


def load(gs, params: dict) -> None:
    """``params`` in place of the solver's own initial weights, refused
    unless every leaf's name and shape is the solver's."""
    mine = to_program(params)
    theirs = {f"{n}/{k}": tuple(v.shape) for n, leaf in gs.params.items()
              for k, v in leaf.items()}
    want = {f"{n}/{k}": tuple(v.shape) for n, leaf in mine.items()
            for k, v in leaf.items()}
    if theirs != want:
        diff = sorted(set(theirs.items()) ^ set(want.items()))[:6]
        raise RuntimeError(f"the solver's weights differ from the net's "
                           f"published shapes: {diff}")
    gs.params = {n: {k: v.to(gs.device) for k, v in leaf.items()}
                 for n, leaf in mine.items()}


def _flat(tree) -> dict:
    return {f"{n}/{k}": v.detach().clone() for n, leaf in tree.items()
            for k, v in leaf.items()}


def first_gradient(history: dict, params0: dict, solver: dict) -> dict:
    """Each leaf's first gradient norm, read from SGD's history after one
    iteration: h = rate lr_mult (g + wd decay_mult w0), rate = base_lr."""
    out = {}
    for key, h in history.items():
        lr_mult, decay_mult = reference.MULTS[key.rsplit("/", 1)[1]]
        g = h.double() / (solver["base_lr"] * lr_mult)
        if decay_mult:
            g = g - solver["weight_decay"] * decay_mult \
                * params0[key].double()
        out[key] = float(torch.linalg.vector_norm(g))
    return out


def readings(losses, g_first: dict, d_got: dict, ref: dict,
             check_losses: int) -> dict:
    """``judge``'s comparisons of a solver's first iterations against the
    reference's: ``loss_gap`` (the first losses, relative), ``grad_gap``
    (the first gradient's norm, the worst leaf above noise) and
    ``median_change_gap`` (the norm of the change over the followed
    iterations, ``d_got``, the median leaf above noise)."""
    want = ref["losses"]
    loss_gap = max(abs(float(losses[s]) - want[s]) / abs(want[s])
                   for s in range(check_losses))
    g_ref = judge._norms(ref["grads"])
    counted = judge.counted(g_ref)
    gaps = judge._gaps(g_first, g_ref, counted)
    d_ref = judge._norms({k: ref["params"][k] - ref["init"][k]
                          for k in ref["init"]})
    change = judge._gaps(d_got, d_ref, counted)
    worst = sorted(zip(gaps, counted), reverse=True)[:3]
    print("first iterations: losses " + ", ".join(
        f"{float(a):.6f} / {b:.6f}" for a, b in zip(losses, want))
        + "; worst grad_gap leaves " + ", ".join(
            f"{k} {g:.3g}" for g, k in worst), file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": max(gaps),
            "median_change_gap": statistics.median(change)}


def changes(params: dict, params0: dict) -> dict:
    """Each leaf's norm of change."""
    return judge._norms({k: params[k] - params0[k] for k in params0})


# ------------------------------------------------------------- the window
class Window:
    """The window's ``action_fn``, polled before each iteration: starts
    the clock (and the trace) at the first poll, stops the trace after
    ``trace_steps`` iterations and the window at the first poll after
    ``seconds``."""

    def __init__(self, run, gs):
        from mms_answer_selection_tpu_torch.training.signals import Action

        self.run, self.gs, self.action = run, gs, Action
        self.trace_steps = int(run.traffic["trace_steps"])
        self.tracer = Tracer() if run.trace else None
        self.it0 = gs.iter_
        self.t0 = self.t_end = self.iters = self.traced = None
        self.every = gs.display or 40
        self.marks: list[float] = []     # the clock every ``every`` iterations

    def __call__(self):
        now = time.perf_counter()
        done = self.gs.iter_ - self.it0
        if self.t0 is None:
            if self.tracer:
                self.tracer.start()
            self.t0 = time.perf_counter()
            self.marks.append(self.t0)
            return self.action.NONE
        if done % self.every == 0:
            self.marks.append(now)
        if self.tracer and self.traced is None and (
                done >= self.trace_steps or now - self.t0 >= self.run.seconds):
            self.run.device_trace = self.tracer.stop()
            self.traced = done
        if now - self.t0 >= self.run.seconds:
            self.t_end, self.iters = now, done
            return self.action.STOP
        return self.action.NONE


def _report_periods(win) -> None:
    """The window's periods of ``every`` iterations on standard error:
    their quantiles, and the share of the window the periods above the
    fastest took beyond it."""
    ms = sorted(1e3 * (b - a) for a, b in zip(win.marks, win.marks[1:]))
    if not ms:
        return
    q = [ms[min(len(ms) - 1, int(f * len(ms)))] for f in (0.1, 0.5, 0.9)]
    excess = sum(m - ms[0] for m in ms) / sum(ms)
    print(f"periods of {win.every} iterations: n {len(ms)}, min "
          f"{ms[0]:.3f}, p10 {q[0]:.3f}, p50 {q[1]:.3f}, p90 {q[2]:.3f}, "
          f"max {ms[-1]:.3f} ms; beyond the fastest {100 * excess:.2f}% "
          f"of the window", file=sys.stderr)


def solver(run, dev, tmp: str):
    """Set-up: the data, the solver, its first iterations kept, the
    warm-up.  Returns (the solver, what was kept, the data)."""
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver

    cfg, tr = run.config, run.traffic
    pixels, labels = images(run.seed, int(cfg["train_images"]),
                            int(cfg["classes"]), dev)
    path, batch = lay_out(run, tmp, pixels, labels)
    run.mark("database written")
    displays = []
    gs = GraphSolver(path, device=dev, seed=run.seed,
                     on_display=displays.append)
    load(gs, reference.init(run.seed, dev))
    run.mark("solver built")
    kept = {"init": _flat(gs.params), "losses": [], "batch": batch,
            "displays": displays}
    for it in range(int(tr["follow"])):
        kept["losses"].append(gs.step(1))
        if it == 0:
            kept["history"] = _flat(gs.opt_state["h"])
    kept["params"] = _flat(gs.params)
    gs.step(int(tr["warm_steps"]) - int(tr["follow"]))
    _sync(dev)
    run.mark("first iterations and warm-up")
    return gs, kept, (pixels, labels)


def measure(run, dev) -> None:
    """Set-up, the window and the check, on ``dev``; the database is
    deleted whatever happens."""
    tr = run.traffic
    tmp = tempfile.mkdtemp(prefix="h100_bench_solver_")
    try:
        gs, kept, data = solver(run, dev, tmp)
        run.setup_done()
        win = Window(run, gs)
        gs.step(gs.max_iter - gs.iter_, action_fn=win)
        if win.t_end is None:
            raise RuntimeError("the solver reached max_iter inside the "
                               "window")
        window_s = win.t_end - win.t0
        batch = kept["batch"]
        every = gs.display
        shown = [d for d in kept["displays"] if d["iter"] >= win.it0]
        run.attempted = win.iters
        # a display holds the loss smoothed over the last ``average_loss``
        # iterations: a non-finite one counts its ``display`` iterations
        run.failed = min(win.iters, every * sum(
            not math.isfinite(d["loss"]) for d in shown))
        run.e2e[tr["rate_metric"]] = win.iters * batch / window_s
        run.work = {"iters": win.iters, "window_s": window_s,
                    "batch": batch, "traced_iters": win.traced}
        _report_periods(win)
        if dev.type == "cuda":
            run.memory_peak = torch.cuda.max_memory_allocated(dev)
        del gs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(run, kept, data)


def check(run, kept, data) -> None:
    """The first iterations against the reference's."""
    tr, sgd = run.traffic, run.config["sgd"]
    pixels, labels = data
    ref = reference.train(pixels, labels, run.seed, sgd, kept["batch"],
                          int(tr["follow"]), run.device)
    g_first = first_gradient(kept["history"], kept["init"], sgd)
    out = readings(kept["losses"], g_first,
                   changes(kept["params"], kept["init"]), ref,
                   int(tr["check_losses"]))
    for name, value in out.items():
        run.compare(name, value, tr["limits"])


def execute(run) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run.device = dev
    measure(run, dev)
