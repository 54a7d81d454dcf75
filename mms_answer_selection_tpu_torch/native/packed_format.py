"""Python side of the native packed-record store (counterpart of
``native/packed_format.py``; ``packed_store.cc`` is the JAX package's
source, byte for byte).

``write_mmsp`` writes the columnar MMSP file; ``PackedStore`` and
``NativePrefetcher`` wrap the C++ mmap, threaded gather and background
prefetch ring through ``ctypes``.  The shared library is built with ``g++``
on first use into ``<package>/build/``, under a name keyed on a hash of the
source and flags, like the CUDA kernels (``ops/_build.py``); a failed
build raises.

``NativePrefetcher.next_device`` hands a batch to the training device: on
CUDA the ring slot is copied into one of two reusable pinned staging sets,
the slot is released at once, and the copies to the card are issued
non-blocking; an event recorded after them is waited on before that
staging set is filled again.  On the CPU the fields are copied out of the
slot before it is released (a tensor made from the slot's memory would
change under the worker's next refill).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device

_DTYPES = {np.dtype(np.int32): 0, np.dtype(np.float32): 1,
           np.dtype(np.int64): 2, np.dtype(np.float64): 3}
_DTYPES_REV = {v: k for k, v in _DTYPES.items()}
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float64): torch.float64}
_MAGIC = 0x50534D4D  # 'MMSP'
_ALIGN = 64

SOURCE = Path(__file__).resolve().parent / "packed_store.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpacked_store_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``packed_store.cc`` unless the keyed library exists; raises
    with the compiler's output when ``g++`` fails or is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found; the packed store cannot be "
                           f"built ({e})") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def _get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    P, U32, U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
    sigs = {
        "mmsp_open": (P, [ctypes.c_char_p]),
        "mmsp_close": (None, [P]),
        "mmsp_rows": (U64, [P]),
        "mmsp_num_fields": (U32, [P]),
        "mmsp_field_info": (ctypes.c_int, [P, U32, ctypes.c_char_p,
                                           ctypes.POINTER(U32),
                                           ctypes.POINTER(U64)]),
        "mmsp_gather": (ctypes.c_int, [P, U32, P, U64, P, ctypes.c_int]),
        "mmsp_shuffle": (None, [U64, U64, P]),
        "mmsp_prefetcher_create": (P, [P, P, U32, U64, U64, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, U64, U64]),
        "mmsp_prefetcher_next": (ctypes.c_int64, [P, P]),
        "mmsp_prefetcher_acquire": (ctypes.c_int64, [P, P, P]),
        "mmsp_prefetcher_release": (None, [P]),
        "mmsp_prefetcher_destroy": (None, [P]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def write_mmsp(path: str, arrays: dict[str, np.ndarray]):
    """Write a dict of equal-length arrays as one MMSP file."""
    items = []
    n_rows = None
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in _DTYPES:
            if np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            arr = arr.reshape(arr.shape[0], -1)
        if n_rows is None:
            n_rows = arr.shape[0]
        elif arr.shape[0] != n_rows:
            raise ValueError("ragged fields")
        items.append((name, arr))

    # C struct Field is 56 bytes (32 name + 4 dtype + 4 pad + 8 cols + 8 off)
    header_size = 20 + len(items) * 56
    offset = (header_size + _ALIGN - 1) // _ALIGN * _ALIGN
    metas = []
    seen_names = set()
    for name, arr in items:
        nb31 = name.encode()[:31]
        if len(name.encode()) > 31 or nb31 in seen_names:
            # the C header stores 31 name bytes + NUL: silent truncation
            # can collapse two fields into one reader key
            raise ValueError(f"field name {name!r} exceeds the 31-byte "
                             f"header limit (or collides after "
                             f"truncation)")
        seen_names.add(nb31)
        metas.append((name, _DTYPES[arr.dtype], arr.shape[1], offset))
        offset += arr.nbytes
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN

    with open(path, "wb") as f:
        f.write(struct.pack("<IIIQ", _MAGIC, 1, len(items), n_rows))
        for name, dtype, cols, off in metas:
            nb = name.encode()[:31]
            f.write(nb + b"\0" * (32 - len(nb)))
            # the C struct layout: u32 dtype, 4 pad, u64 cols, u64 off
            f.write(struct.pack("<IIQQ", dtype, 0, cols, off))
        for (name, arr), (_, _, _, off) in zip(items, metas):
            f.seek(off)
            f.write(arr.tobytes())


class PackedStore:
    """mmap'd random-access reader with native multithreaded gather."""

    def __init__(self, path: str):
        self.lib = _get_lib()
        self.handle = self.lib.mmsp_open(path.encode())
        if not self.handle:
            raise IOError(f"cannot open MMSP file {path}")
        self.n_rows = self.lib.mmsp_rows(self.handle)
        self.fields = {}
        for i in range(self.lib.mmsp_num_fields(self.handle)):
            name = ctypes.create_string_buffer(32)
            dtype = ctypes.c_uint32()
            cols = ctypes.c_uint64()
            self.lib.mmsp_field_info(self.handle, i, name,
                                     ctypes.byref(dtype), ctypes.byref(cols))
            self.fields[name.value.decode()] = (i, _DTYPES_REV[dtype.value],
                                                int(cols.value))

    def gather(self, field: str, idx, *, threads: int = 4) -> np.ndarray:
        fid, dtype, cols = self.fields[field]
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((len(idx), cols), dtype)
        rc = self.lib.mmsp_gather(
            self.handle, fid, idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            out.ctypes.data_as(ctypes.c_void_p), threads)
        if rc != 0:
            raise IndexError(f"gather failed rc={rc}")
        return out

    def close(self):
        if self.handle:
            self.lib.mmsp_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def native_shuffle(n: int, seed: int) -> np.ndarray:
    if n <= 0:
        # the C Fisher-Yates computes splitmix64 % (i+1) with i wrapping
        # to (uint64)-1 for n == 0: SIGFPE in the worker
        raise ValueError(f"native_shuffle needs n > 0, got {n}")
    out = np.empty(n, np.int64)
    _get_lib().mmsp_shuffle(n, seed, out.ctypes.data_as(ctypes.c_void_p))
    return out


class NativePrefetcher:
    """Background-thread batch stream over a PackedStore: the reference's
    prefetch thread + free/full BlockingQueue pair, as a native ring."""

    def __init__(self, store: PackedStore, fields, batch_size: int, *,
                 seed: int = 0, shuffle: bool = True, depth: int = 3,
                 gather_threads: int = 4, shard: tuple[int, int] = (0, 1)):
        self.store = store
        self.lib = store.lib
        self.field_names = list(fields)
        fids = np.asarray([store.fields[f][0] for f in self.field_names],
                          np.uint32)
        self.shapes = [(batch_size, store.fields[f][2], store.fields[f][1])
                       for f in self.field_names]
        per_shard = len(range(shard[0], store.n_rows, shard[1]))
        if store.n_rows <= 0 or per_shard <= 0:
            # an empty store (or empty stripe) would SIGFPE in the native
            # reshuffle or read an empty permutation out of bounds
            raise ValueError(
                f"shard {shard[0]}/{shard[1]} of a {store.n_rows}-row "
                f"store is empty")
        self.handle = self.lib.mmsp_prefetcher_create(
            store.handle, fids.ctypes.data_as(ctypes.c_void_p), len(fids),
            batch_size, seed, int(shuffle), depth, gather_threads,
            shard[0], shard[1])
        self._staging = None   # two pinned sets, made on the first CUDA call
        self._turn = 0

    def next(self) -> dict[str, np.ndarray]:
        outs = [np.empty((bs, cols), dtype)
                for (bs, cols, dtype) in self.shapes]
        ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        step = self.lib.mmsp_prefetcher_next(self.handle, ptrs)
        if step < 0:
            raise StopIteration
        return {name: arr for name, arr in zip(self.field_names, outs)}

    def acquire_view(self):
        """Zero-copy batch: (step, dict of numpy VIEWS into the ring slot).
        The views alias native memory owned by the prefetcher; the caller
        must be done with them (or have copied them) before calling
        :meth:`release`, which recycles the slot."""
        n = len(self.field_names)
        ptrs = (ctypes.c_void_p * n)()
        sizes = (ctypes.c_uint64 * n)()
        step = self.lib.mmsp_prefetcher_acquire(self.handle, ptrs, sizes)
        if step == -2:
            raise RuntimeError("acquire called twice without release")
        if step < 0:
            raise StopIteration
        out = {}
        for name, (bs, cols, dtype), ptr in zip(self.field_names,
                                                self.shapes, ptrs):
            buf = (ctypes.c_char * (bs * cols * dtype.itemsize)) \
                .from_address(ptr)
            out[name] = np.frombuffer(buf, dtype).reshape(bs, cols)
        return step, out

    def release(self):
        self.lib.mmsp_prefetcher_release(self.handle)

    def _staging_set(self):
        """The next of two pinned host sets, once the copies last issued
        from it have finished."""
        if self._staging is None:
            self._staging = [
                ({name: torch.empty((bs, cols), dtype=_TORCH_DTYPES[dtype],
                                    pin_memory=True)
                  for name, (bs, cols, dtype) in zip(self.field_names,
                                                     self.shapes)}, None)
                for _ in range(2)]
        buffers, event = self._staging[self._turn]
        if event is not None:
            event.synchronize()
        return buffers

    def next_device(self, device=None) -> dict[str, torch.Tensor]:
        """The next batch as tensors on ``device`` (``None`` means CUDA).
        CUDA: slot -> pinned staging set (host copy), slot released,
        non-blocking copies to the card, an event recorded after them.
        CPU: the fields copied out of the slot before it is released."""
        device = resolve_device(device)
        if device.type == "cuda":
            buffers = self._staging_set()
            _, views = self.acquire_view()
            try:
                for name, view in views.items():
                    np.copyto(buffers[name].numpy(), view)
            finally:
                self.release()
            batch = {name: t.to(device, non_blocking=True)
                     for name, t in buffers.items()}
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._staging[self._turn] = (buffers, event)
            self._turn ^= 1
            return batch
        _, views = self.acquire_view()
        try:
            return {name: torch.from_numpy(np.array(view))
                    for name, view in views.items()}
        finally:
            self.release()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def close(self):
        if self.handle:
            self.lib.mmsp_prefetcher_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
