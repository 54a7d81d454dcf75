"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into an object (the ``*.cuh``
headers beside them are included), one process per source, all started
together, and links the objects into one shared
library with a plain C interface, loaded with ``ctypes``: pointers and the
stream travel as ``c_void_p``, sizes as ``c_int``, and every C entry point
returns the ``cudaError_t`` of its launch.  Nothing includes PyTorch's
headers, so a build takes seconds.

The library lands in ``<package>/build/`` under a name keyed on a hash of
the sources, headers included, and flags, so an edited source or header
rebuilds and an unchanged one is reused.  Importing this module builds nothing; the first CUDA launch
calls ``load_library``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures -> cudaError_t.  MaxSim: (pointers..., nq, r, c, w2p, dp,
# launch plan..., device, stream), the plan (queries per group, candidates
# per tile, tokens per slab, tile width, stages, tiles per unit, grid,
# K-sliced) of
# ``maxsim_geometry``; pair maps: (pointers..., n, w1, w2, d, m, launch
# geometry..., device, stream), the geometry (rows, te, w2 tile, threads)
# for the forward, (te, measures per group, then samples, x rows and output
# rows for dQ and for dA) for dQ/dA, (samples per chunk, d_rows, te, w1
# tile, threads) for dW
_SIGNATURES = {
    "maxsim_bf16": [_P] * 3 + [_I] * 14 + [_P],
    "maxsim_int8": [_P] * 5 + [_I] * 14 + [_P],
    "maxsim_int4": [_P] * 5 + [_I] * 14 + [_P],
    "pair_maps_fwd": [_P] * 5 + [_I] * 10 + [_P],
    "pair_maps_bwd_qa": [_P] * 6 + [_I] * 14 + [_P],
    "pair_maps_bwd_w": [_P] * 5 + [_I] * 11 + [_P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _hashed() -> list[Path]:
    """Every file a build reads: the sources and the headers they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the keyed library exists.  Returns the
    path and the seconds spent compiling (0.0 when it was reused).  The
    ptxas report (registers, shared memory, spills) is kept beside the
    library as ``.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in _sources()]
    t0 = time.perf_counter()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for obj, src in zip(objs, _sources()))]
    logs, failed = [], []
    for cmd, proc in jobs:      # wait for every compile, failed or not
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode:
            failed.append(f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.maxsim_error_string.argtypes = [ctypes.c_int]
    lib.maxsim_error_string.restype = ctypes.c_char_p
    return lib
