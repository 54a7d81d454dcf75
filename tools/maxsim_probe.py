#!/usr/bin/env python3
"""Times the MaxSim kernels of ``csrc/maxsim_*.cu`` against an earlier
version of those sources on one GPU, the engine's ``query`` and
``query_rerank`` with either kernel set, and the CUDA cores' rate of 32-bit
max operations, which sets the floor of the token max.

    mkdir -p _scratch/maxsim_before
    git archive <commit> mms_answer_selection_tpu_torch/csrc | \\
        tar -x --strip-components=2 -C _scratch/maxsim_before
    python3 tools/maxsim_probe.py --before _scratch/maxsim_before

The earlier sources must export ``maxsim_bf16(qw, pool, out, nq, r, c, w2p,
dp, g, n_c, w2s, n, stages, tiles_per_unit, grid, device, stream)`` and
``maxsim_int8`` / ``maxsim_int4(qw, qs, pool, aux, out, ...the same
ints...)``, as e2bf046's do; they are launched with the resident plan that
``maxsim_geometry`` gives V4's shapes.  ``--quick`` times the kernels
alone (no max-rate or engine phase).  Every kernel time is a burst of
launches between two CUDA events (``chip_smoke.burst_ms``), taken in turns:
before, now, now, before, at 1, 16, 32 and 256 queries x 262,144 candidates
and 16 x 8,192, V4's widths (R = 160, W2P = 40, D = 50), each beside its
bound and the max floor.  Needs a CUDA device; prints one line per
measurement and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import burst_ms, maxsim_bound, sync_ms  # noqa: E402

D, W1, W2, M = 50, 40, 40, 4
R = M * W1
POOL = 262_144
SHAPES = ((1, POOL), (16, POOL), (32, POOL), (256, POOL), (16, 8192))
KINDS = ("bf16", "int8", "int4")

# max-throughput micro-kernel: 1,024 threads a block, one block per SM,
# 16 registers each folded with its neighbour per step (no two steps the
# same, so nothing folds), clock64 around the loop
RATE_SRC = r"""
#include <stdint.h>
template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b, uint32_t c) {
  if (OP == 0) return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  if (OP == 1) return (uint32_t)max((int)a, (int)b);
  return (uint32_t)__vimax3_s32((int)a, (int)b, (int)c);
}
template <int OP>
__global__ void rate(uint32_t* out, unsigned long long* cycles, int iters) {
  uint32_t r[16];
  for (int i = 0; i < 16; ++i) r[i] = (threadIdx.x * 2654435761u) ^ (i * 40503u);
  __syncthreads();
  const unsigned long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = step<OP>(r[i], r[(i + 1) & 15], r[(i + 5) & 15]);
  }
  __syncthreads();
  const unsigned long long t1 = clock64();
  uint32_t s = 0;
  for (int i = 0; i < 16; ++i) s ^= r[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run_rate(int op, void* out, void* cycles, int blocks, int iters) {
  if (op == 0) rate<0><<<blocks, 1024>>>((uint32_t*)out, (unsigned long long*)cycles, iters);
  if (op == 1) rate<1><<<blocks, 1024>>>((uint32_t*)out, (unsigned long long*)cycles, iters);
  if (op == 2) rate<2><<<blocks, 1024>>>((uint32_t*)out, (unsigned long long*)cycles, iters);
  return (int)cudaDeviceSynchronize();
}
"""


def nvcc_lib(name: str, sources: list[str]) -> ctypes.CDLL:
    """Sources compiled with the package's flags into build/<name>.so."""
    from mms_answer_selection_tpu_torch.ops import _build

    so = _build.BUILD_DIR / f"{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so), *sources], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    return ctypes.CDLL(str(so))


def before_kernels(src_dir: Path):
    """The earlier kernels as a library of their own, and wrappers that
    launch them with the plan ``maxsim_geometry`` gives the shape (its
    first seven numbers: the earlier entry points take no K-sliced flag,
    and V4's shapes keep the resident plan)."""
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    lib = nvcc_lib("maxsim_before", [str(src_dir / "maxsim_bf16.cu"),
                                     str(src_dir / "maxsim_int8.cu")])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_bf16.argtypes = [p] * 3 + [i] * 13 + [p]
    lib.maxsim_int8.argtypes = [p] * 5 + [i] * 13 + [p]
    lib.maxsim_int4.argtypes = [p] * 5 + [i] * 13 + [p]

    def plan(nq, r, c, w2p, dp, kind):
        geo = sk.maxsim_geometry(nq, r, c, w2p, dp, kind)
        if geo.k_sliced:
            raise ValueError("the earlier kernels have no K-sliced plan")
        return sk._plan_args(geo)[:7]

    def call(fn, like, *args):
        err = fn(*args, like.device.index or 0,
                 torch.cuda.current_stream(like.device).cuda_stream)
        if err:
            raise RuntimeError(f"earlier MaxSim kernel failed: {err}")

    def bf16(qw, pool):
        nq, r, dp = qw.shape
        c, w2p = pool.shape[:2]
        out = torch.empty((nq, c), device=qw.device)
        call(lib.maxsim_bf16, qw, qw.data_ptr(), pool.data_ptr(),
             out.data_ptr(), nq, r, c, w2p, dp,
             *plan(nq, r, c, w2p, dp, "bf16"))
        return out

    def quantized(fn, kind):
        def run(qw, qs, pool, aux):
            nq, r, dp = qw.shape
            c, w2p = pool.shape[:2]
            sq = qs.to(torch.bfloat16).to(torch.float32)
            out = torch.empty((nq, c), device=qw.device)
            call(fn, qw, qw.data_ptr(), sq.data_ptr(), pool.data_ptr(),
                 aux.data_ptr(), out.data_ptr(), nq, r, c, w2p, dp,
                 *plan(nq, r, c, w2p, dp, kind))
            return out
        return run

    return {"bf16": bf16, "int8": quantized(lib.maxsim_int8, "int8"),
            "int4": quantized(lib.maxsim_int4, "int4")}, sk


def max_rates(card: str) -> dict:
    """Per-SM per-clock rate of FMNMX, IMNMX and VIMNMX3 (3-operand, two
    max operations an instruction)."""
    lib = nvcc_lib("maxsim_rate", [str(_write_rate_src())])
    lib.run_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int]
    blocks, iters = 132, 4096
    out = torch.empty(blocks * 1024, dtype=torch.int32, device="cuda")
    cyc = torch.empty(blocks, dtype=torch.int64, device="cuda")
    rates = {}
    for op, name, per in ((0, "fmax.f32 (FMNMX)", 1), (1, "max.s32 (IMNMX)", 1),
                          (2, "vimax3.s32 (VIMNMX3)", 2)):
        lib.run_rate(op, out.data_ptr(), cyc.data_ptr(), blocks, iters)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.run_rate(op, out.data_ptr(), cyc.data_ptr(), blocks, iters)
        end.record()
        end.synchronize()
        if err:
            raise RuntimeError(f"rate kernel failed: {err}")
        instr = 1024 * iters * 16
        cycles = float(cyc.double().median())
        ghz = cycles / (start.elapsed_time(end) * 1e6)
        rates[op] = (instr / cycles, per, ghz)
        print(f"rate {name}: {instr / cycles:.1f} instructions, "
              f"{per * instr / cycles:.1f} max operations per clock per SM "
              f"({ghz:.3f} GHz in the run) [{card}]", flush=True)
    return rates


def _write_rate_src() -> Path:
    from mms_answer_selection_tpu_torch.ops import _build

    path = _build.BUILD_DIR / "maxsim_rate.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(RATE_SRC)
    return path


def operands(sk, kind, nq, c, gen):
    def normal(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale
    w = normal(M, D, D, scale=0.05)
    q, cand = normal(nq, W1, D, scale=0.3), normal(c, W2, D, scale=0.3)
    if kind == "bf16":
        return sk.project_queries(q, w), sk.pack_candidate_pool(cand)
    if kind == "int8":
        return (*sk.project_queries_int8(q, w),
                *sk.pack_candidate_pool_int8(cand))
    return (*sk.project_queries_int4(q, w), *sk.pack_candidate_pool_int4(cand))


def kernel_phase(sk, before, rates, gen, card: str) -> None:
    now = {"bf16": sk.bilinear_maxsim_scores,
           "int8": sk.bilinear_maxsim_scores_int8,
           "int4": sk.bilinear_maxsim_scores_int4}
    fmax = rates[0][0]                      # FMNMX per clock per SM
    imax = rates[2][0] * rates[2][1]        # max operations a clock, vimax3
    ghz = rates[0][2]
    for kind in KINDS:
        for nq, c in SHAPES:
            args = operands(sk, kind, nq, c, gen)
            old, new = before[kind](*args), now[kind](*args)
            torch.cuda.synchronize()
            diff = float((old - new).abs().max() / new.abs().max())
            reps = max(3, min(200, 2_000_000 // (nq * c)))
            t = [burst_ms(lambda f=f: f(*args), reps)
                 for f in (before[kind], now[kind], now[kind], before[kind])]
            b_ms, b_by = maxsim_bound("maxsim_" + kind, args, nq * c * 4)
            rate = fmax if kind == "bf16" else imax
            floor = nq * R * c * W2 / (rate * 132 * ghz * 1e9) * 1e3
            k_ms, o_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            print(f"time maxsim_{kind} {nq}q x {c}: now {k_ms:.4f} ms, before "
                  f"{o_ms:.4f} ms ({o_ms / k_ms:.2f}x), bound {b_ms:.4f} ms "
                  f"({b_by}; {b_ms / k_ms:.1%} now, {b_ms / o_ms:.1%} before),"
                  f" max floor {floor:.4f} ms; now vs before max rel diff "
                  f"{diff:.2e} {[round(x, 4) for x in t]} [{card}]",
                  flush=True)
            del args


def engine_phase(sk, before, gen, card: str) -> None:
    """query (1 and 256 q) and query_rerank (32 q, S = 50) p50 on a
    262,144-candidate engine of each dtype, with either kernel set."""
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        MMSQAConfig, mms_qa_init)
    from mms_answer_selection_tpu_torch.serve import QueryEngine

    names = {"bf16": "bilinear_maxsim_scores",
             "int8": "bilinear_maxsim_scores_int8",
             "int4": "bilinear_maxsim_scores_int4"}
    now = {k: getattr(sk, v) for k, v in names.items()}
    cfg = MMSQAConfig(vocab_size=50_000)
    params, state = mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        0), device="cuda")
    params["embed"]["w"] = torch.randn((50_000, D), generator=gen,
                                       device="cuda") * 0.3
    params["sim"]["w"] = torch.randn((M, D, D), generator=gen,
                                     device="cuda") * 0.05
    for name in state:
        state[name] = {"mean": state[name]["mean"],
                       "var": state[name]["var"] + 0.5}
    cand = torch.randint(0, 50_000, (POOL, W2), generator=gen, device="cuda")
    queries = torch.randint(0, 50_000, (256, W1), generator=gen,
                            device="cuda")
    for kind in KINDS:
        eng = QueryEngine(params, cfg, pool_dtype=kind, chunk_size=131_072,
                          device="cuda").build_index(cand)
        line = []
        for what, fn, reps in (
                ("query 1q", lambda: eng.query(queries[:1], k=10), 20),
                ("query 256q", lambda: eng.query(queries, k=10), 5),
                ("query_rerank 32q S=50", lambda: eng.query_rerank(
                    state, queries[:32], k=10, shortlist=50), 10)):
            t = []
            for use in (before[kind], now[kind], now[kind], before[kind]):
                setattr(sk, names[kind], use)
                t.append(sync_ms(fn, reps))
            setattr(sk, names[kind], now[kind])
            line.append(f"{what} p50 now {(t[1] + t[2]) / 2:.3f} ms, before "
                        f"{(t[0] + t[3]) / 2:.3f} ms {[round(x, 3) for x in t]}")
        print(f"engine {kind} at {POOL}: " + "; ".join(line) + f" [{card}]",
              flush=True)
        del eng
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=Path, required=True,
                    help="directory holding the earlier maxsim_bf16.cu and "
                         "maxsim_int8.cu")
    ap.add_argument("--quick", action="store_true",
                    help="the kernel phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("maxsim_probe: no CUDA device", file=sys.stderr)
        return 2
    from mms_answer_selection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    _build.load_library()
    before, sk = before_kernels(args.before)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rates = max_rates(card)
    kernel_phase(sk, before, rates, gen, card)
    if not args.quick:
        engine_phase(sk, before, gen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
