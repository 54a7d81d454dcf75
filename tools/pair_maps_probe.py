#!/usr/bin/env python3
"""Times the pair-map kernels of ``csrc/pair_maps.cu`` (forward, dQ / dA
and dW) against an earlier version of that source on one GPU, the launch
plans next to the ones the plan rules pass over, and the train steps that
run the kernels.

    git show <commit>:mms_answer_selection_tpu_torch/csrc/pair_maps.cu \\
        > _scratch/pair_maps_before.cu
    python3 tools/pair_maps_probe.py --before _scratch/pair_maps_before.cu

The earlier source must export the entry points of e2bf046's:
``pair_maps_fwd(q, a, w, out, part, n, w1, w2, d, m, rows, te, threads,
device, stream)``, ``pair_maps_bwd_w(q, a, g, dw, part, n, w1, w2, d, m,
n_per, d_rows, te, threads, device, stream)`` and ``pair_maps_bwd_qa(q, a,
w, g, dq, da, n, w1, w2, d, m, device, stream)``; its forward and dW run
the current rules' plans (the same for W <= 64).  Every time is a burst of
launches between two CUDA events (``chip_smoke.burst_ms``), taken in
turns: einsum, before, now, now, before, einsum; dQ and dA's yardstick is
their two einsums.  Then V4 at batch 1024 and V4_WIDE (D = 300) at batch
50 and 1024 train on synthetic corpus batches with the earlier and the
current kernels in turns (step p50, host clock and a device sync), and
``torch.profiler`` reads each step's device time and the pair maps' share
of it.  ``--skip-plans`` leaves out the plan phase.  Needs a CUDA device;
prints one line per measurement and the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import burst_ms, pair_bound, sync_ms  # noqa: E402

W1, W2, M = 40, 40, 4
SHAPES = ((50, 50), (1024, 50), (50, 300), (1024, 300))   # (N, D)
FWD_ONLY = ((1600, 50),)                     # the rerank's pairs
REPS = 100


def build_before(src: Path) -> ctypes.CDLL:
    """The earlier source as a shared library of its own, beside the
    current one in the build directory."""
    from mms_answer_selection_tpu_torch.ops import _build

    so = _build.BUILD_DIR / "pair_maps_before.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pair_maps_fwd.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.pair_maps_bwd_w.argtypes = [p] * 5 + [i] * 10 + [p]
    lib.pair_maps_bwd_qa.argtypes = [p] * 6 + [i] * 6 + [p]
    return lib


def before_kernels(lib, sk):
    """Wrappers of the earlier kernels (forward, dQ / dA, dW), launched as
    its Python side did, with the current rules' plans."""
    def call(fn, q, *args):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, q.device.index or 0, stream)
        if err:
            raise RuntimeError(f"earlier pair-map kernel failed: {err}")

    def fwd(q, a, w):
        n, w1, d = q.shape
        w2, m = a.shape[1], w.shape[0]
        geo = sk.pair_maps_fwd_geometry(n, w1, w2, d, m)
        out = torch.empty((n, w1, w2, m), device=q.device)
        part = torch.empty((geo.col_tiles, n, w1, w2, m), device=q.device) \
            if geo.col_tiles > 1 else out
        call(lib.pair_maps_fwd, q, q.data_ptr(), a.data_ptr(), w.data_ptr(),
             out.data_ptr(), part.data_ptr(), n, w1, w2, d, m, geo.rows,
             geo.te, geo.threads)
        return out

    def bwd_qa(q, a, w, g):
        g = g.contiguous()
        n, w1, d = q.shape
        dq, da = torch.empty_like(q), torch.empty_like(a)
        call(lib.pair_maps_bwd_qa, q, q.data_ptr(), a.data_ptr(),
             w.data_ptr(), g.data_ptr(), dq.data_ptr(), da.data_ptr(), n, w1,
             a.shape[1], d, w.shape[0])
        return dq, da

    def bwd_w(q, a, w, g):
        g = g.contiguous()
        n, w1, d = q.shape
        geo = sk.pair_maps_bwd_w_geometry(n, w1, a.shape[1], d, w.shape[0])
        dw = torch.empty_like(w)
        part = torch.empty((geo.chunks,) + tuple(w.shape), device=w.device) \
            if geo.chunks > 1 else dw
        call(lib.pair_maps_bwd_w, q, q.data_ptr(), a.data_ptr(),
             g.data_ptr(), dw.data_ptr(), part.data_ptr(), n, w1,
             a.shape[1], d, w.shape[0], geo.n_per, geo.d_rows, geo.te,
             geo.threads)
        return dw

    return fwd, bwd_qa, bwd_w


def kernel_phase(sk, before, normal, card: str) -> None:
    fwd_b, qa_b, dw_b = before
    grads = sk.bilinear_pair_maps_grads_plain

    def both(f):   # dQ and dA as one tensor, to compare
        return lambda *o: torch.cat([t.flatten() for t in f(*o)])

    kernels = {
        "pair_maps_fwd": (lambda q, a, w, g: sk.bilinear_pair_maps_plain(
            q, a, w), lambda q, a, w, g: fwd_b(q, a, w),
            lambda q, a, w, g: sk.pair_maps_fwd(q, a, w)),
        "pair_maps_bwd_qa": (both(lambda *o: grads(*o, need_w=False)[:2]),
                             both(qa_b), both(sk.pair_maps_bwd_qa)),
        "pair_maps_bwd_w": (lambda *o: grads(*o, need_qa=False)[2], dw_b,
                            sk.pair_maps_bwd_w)}
    for n, d in SHAPES + FWD_ONLY:
        ops = (normal(n, W1, d, scale=0.3), normal(n, W2, d, scale=0.3),
               normal(M, d, d, scale=0.05), normal(n, W1, W2, M))
        for name, (plain, old, new) in kernels.items():
            if (n, d) in FWD_ONLY and name != "pair_maps_fwd":
                continue
            want = plain(*ops)
            errs = [float((f(*ops) - want).abs().max() / want.abs().max())
                    for f in (old, new)]
            if max(errs) > sk.KERNEL_VS_PLAIN_RTOL[name]:
                raise AssertionError(f"{name} N={n} D={d}: {errs}")
            t = [burst_ms(lambda f=f: f(*ops), REPS)
                 for f in (plain, old, new, new, old, plain)]
            b_ms, b_by = pair_bound(name, n, d)
            e_ms, o_ms, k_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, \
                (t[2] + t[3]) / 2
            print(f"time {name} N={n} D={d}: now {k_ms:.4f} ms, before "
                  f"{o_ms:.4f} ms ({o_ms / k_ms:.2f}x), einsum {e_ms:.4f} ms "
                  f"({e_ms / k_ms:.2f}x), bound {b_ms:.4f} ms ({b_by}; "
                  f"{b_ms / k_ms:.1%} now, {b_ms / o_ms:.1%} before); rel err "
                  f"now {errs[1]:.2e}, before {errs[0]:.2e} "
                  f"{[round(x, 4) for x in t]} [{card}]", flush=True)


def plan_phase(sk, normal, card: str) -> None:
    """Each rule's plan (first) against the plans it passes over."""
    fwd = {(50, 50): [(20, 56), (40, 56), (10, 56)],
           (1024, 50): [(40, 56), (20, 56)],
           (50, 300): [(40, 64), (40, 32), (40, 56)]}
    dw = {(50, 50): [(1, 50, 32), (1, 50, 56), (1, 50, 24)],
          (1024, 50): [(8, 50, 56), (16, 50, 56), (4, 50, 56)],
          (50, 300): [(5, 300, 24), (10, 300, 24), (2, 300, 24)]}
    rule_f, rule_w = sk.pair_maps_fwd_geometry, sk.pair_maps_bwd_w_geometry
    try:
        for (n, d), plans in fwd.items():
            q, a, w = (normal(n, W1, d), normal(n, W2, d), normal(M, d, d))
            assert rule_f(n, W1, W2, d, M) == sk.fwd_launch(W2, d, *plans[0])
            for rows, te in plans:
                geo = sk.fwd_launch(W2, d, rows, te)
                sk.pair_maps_fwd_geometry = lambda *s, plan=geo: plan
                ms = burst_ms(lambda: sk.pair_maps_fwd(q, a, w), REPS)
                print(f"plan pair_maps_fwd N={n} D={d} rows={rows} te={te} "
                      f"col_tiles={geo.col_tiles}: {ms:.4f} ms [{card}]",
                      flush=True)
            sk.pair_maps_fwd_geometry = rule_f
        for (n, d), plans in dw.items():
            q, a, w, g = (normal(n, W1, d), normal(n, W2, d),
                          normal(M, d, d), normal(n, W1, W2, M))
            assert rule_w(n, W1, W2, d, M) == sk.dw_launch(n, W1, W2, d,
                                                           *plans[0])
            for plan in plans:
                geo = sk.dw_launch(n, W1, W2, d, *plan)
                sk.pair_maps_bwd_w_geometry = lambda *s, plan=geo: plan
                ms = burst_ms(lambda: sk.pair_maps_bwd_w(q, a, w, g), REPS)
                print(f"plan pair_maps_bwd_w N={n} D={d} n_per={plan[0]} "
                      f"chunks={geo.chunks} d_rows={plan[1]} te={plan[2]}: "
                      f"{ms:.4f} ms [{card}]", flush=True)
            sk.pair_maps_bwd_w_geometry = rule_w
    finally:
        sk.pair_maps_fwd_geometry = rule_f
        sk.pair_maps_bwd_w_geometry = rule_w


def step_phase(sk, before, card: str) -> None:
    """Train steps on corpus batches with the earlier and the current
    pair-map kernels, in turns, and one profile of each."""
    from torch.autograd import DeviceType

    from mms_answer_selection_tpu_torch.data import (
        prepare_trec_qa, synthetic_split, synthetic_world)
    from mms_answer_selection_tpu_torch.models.mms_qa import V4, V4_WIDE
    from mms_answer_selection_tpu_torch.training import (
        SolverConfig, Trainer, TrainerConfig)

    now = (sk.pair_maps_fwd, sk.pair_maps_bwd_qa, sk.pair_maps_bwd_w)

    def use(kernels):
        sk.pair_maps_fwd, sk.pair_maps_bwd_qa, sk.pair_maps_bwd_w = kernels

    recipe = SolverConfig(solver_type="adadelta", base_lr=1.0, momentum=0.95,
                          delta=5e-7, weight_decay=5e-4)
    for model, dim, batches in ((V4, 50, (1024,)), (V4_WIDE, 300, (50, 1024))):
        world = synthetic_world(vocab_words=22500, n_topics=250, dim=dim,
                                seed=22)
        splits, info = prepare_trec_qa(
            synthetic_split(world, 1250, 30, 50, seed=101),
            synthetic_split(world, 65, 12, 24, seed=202),
            synthetic_split(world, 68, 15, 29, seed=303), world["w2v"])
        model = dataclasses.replace(model, vocab_size=info["vocab_size"])
        for b in batches:
            tr = Trainer(model, TrainerConfig(solver=recipe, batch_size=b,
                                              seed=22), device="cuda")
            p, s, o = tr.init(pretrained=info["pretrained"])
            train = tr._full_batch({k: v for k, v in splits["train"].items()
                                    if k != "group"})
            batch = next(tr._epoch_batches(train, 0))

            def step():
                tr._train_step(p, s, o, batch, 0)

            reps = max(10, 1000 // b)
            t = []
            for kernels in (before, now, now, before):
                use(kernels)
                t.append(sync_ms(step, reps))
            use(now)
            line = []
            for label, kernels in (("now", now), ("before", before)):
                use(kernels)
                step()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        step()
                    torch.cuda.synchronize()
                rows = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA]
                total = sum(e.self_device_time_total for e in rows) / 3e3
                pm = sum(e.self_device_time_total for e in rows
                         if "pair_maps" in e.key or "sum_partials" in e.key
                         ) / 3e3
                line.append(f"{label}: device {total:.3f} ms/step, pair maps "
                            f"{pm:.3f} ms")
            use(now)
            name = "V4" if dim == 50 else "V4_WIDE"
            print(f"step {name} batch {b}: p50 now {(t[1] + t[2]) / 2:.3f} ms"
                  f", before {(t[0] + t[3]) / 2:.3f} ms "
                  f"{[round(x, 3) for x in t]}; profile " + "; ".join(line)
                  + f" [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, required=True,
                    help="the earlier csrc/pair_maps.cu")
    ap.add_argument("--skip-plans", action="store_true",
                    help="leave out the plan phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pair_maps_probe: no CUDA device", file=sys.stderr)
        return 2
    from mms_answer_selection_tpu_torch.ops import _build
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    _build.load_library()
    before = before_kernels(build_before(args.before), sk)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    kernel_phase(sk, before, normal, card)
    if not args.skip_plans:
        plan_phase(sk, normal, card)
    step_phase(sk, before, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
