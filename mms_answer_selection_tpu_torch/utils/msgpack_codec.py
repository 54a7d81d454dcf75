"""The checkpoint wire format: flax's ``msgpack_serialize`` /
``msgpack_restore``, written out by hand (no flax, no ``msgpack`` package).

A bundle is a tree of dicts with str keys, lists, str, int, float, bool,
None, numpy arrays and numpy scalars.  It is encoded as flax encodes it:

* dict keys in sorted order (flax copies the tree through ``jax.tree_util``,
  which sorts them); tuples are refused (flax packs with ``strict_types``);
* a numpy array is ext type 1 whose payload is the msgpack array (shape,
  dtype name, C-order bytes), packed with ``use_bin_type``; a numpy scalar
  is ext type 3 with the payload of its 0-d array;
* an array past ``MAX_CHUNK_SIZE`` bytes becomes
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat chunk, ...}}``, each chunk at most that many bytes.

For the same bundle ``packb`` gives flax's bytes, and ``unpackb`` gives
what ``msgpack_restore`` gives: lists stay lists, chunked arrays are joined
again, numpy scalars come back as numpy scalars.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 byte limit, with a
# margin
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --------------------------------------------------------------------- pack
def _pack_int(x: int, out: list) -> None:
    if -32 <= x < 128:
        out.append(struct.pack("b" if x < 0 else "B", x))
    elif x >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if x < limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if x >= -limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack's int64")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, bits), ...) whose width holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, bits in codes:
        if n < (1 << bits):
            out.append(bytes([code]) + n.to_bytes(bits // 8, "big"))
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too long")


def _pack_str(s: str, out: list) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, ((0xD9, 8), (0xDA, 16), (0xDB, 32)), out)
    out.append(b)


def _pack_bin(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, ((0xC4, 8), (0xC5, 16), (0xC6, 32)), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: list) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(bytes([fixed[len(data)], code]))
    else:
        _pack_len(len(data), None, 0, ((0xC7, 8), (0xC8, 16), (0xC9, 32)),
                  out)
        out.append(bytes([code]))
    out.append(data)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, bytes))."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out: list = []
    _pack_len(3, 0x90, 16, (), out)
    _pack_len(arr.ndim, 0x90, 16, ((0xDC, 16), (0xDD, 32)), out)
    for n in arr.shape:
        _pack_int(int(n), out)
    _pack_str(arr.dtype.name, out)
    _pack_bin(arr.tobytes("C"), out)
    return b"".join(out)


def _pack_map(items: dict, out: list, *, sort: bool = True) -> None:
    keys = sorted(items) if sort else list(items)
    _pack_len(len(keys), 0x80, 16, ((0xDE, 16), (0xDF, 32)), out)
    for k in keys:
        _pack(k, out)
        v = items[k]
        if isinstance(v, np.ndarray) \
                and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack_chunked(v, out)
        else:
            _pack(v, out)


def _pack_chunked(arr: np.ndarray, out: list) -> None:
    """flax's ``_chunk``: a map in insertion order (not sorted), its
    "shape" and "chunks" maps keyed "0", "1", ... in index order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    _pack_len(3, 0x80, 16, (), out)
    _pack(_CHUNKED, out)
    _pack(True, out)
    _pack("shape", out)
    _pack_map({str(i): int(n) for i, n in enumerate(arr.shape)}, out,
              sort=False)
    _pack("chunks", out)
    _pack_map({str(i): flat[a:a + size] for i, a in
               enumerate(range(0, flat.size, size))}, out, sort=False)


def _pack(x, out: list) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        _pack_str(x, out)
    elif t is bytes:
        _pack_bin(x, out)
    elif t is dict:
        _pack_map(x, out)
    elif t is list:
        # flax chunks the arrays of dicts only, not those of lists
        _pack_len(len(x), 0x90, 16, ((0xDC, 16), (0xDD, 32)), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out: list = []
    if isinstance(tree, np.ndarray) \
            and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        _pack_chunked(tree, out)
    else:
        _pack(tree, out)
    return b"".join(out)


# ------------------------------------------------------------------- unpack
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
          0xD3: ">q"}


def _unpack(r: _Reader, raw: bool):
    b = r.uint(1)
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.uint(1 << (b - 0xC4))))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.uint(1 << (b - 0xC7))
        return _ext(r.uint(1), bytes(r.take(n)))
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack(fmt, r.take(struct.calcsize(fmt)))[0]
    if 0xCC <= b <= 0xCF:
        return r.uint(1 << (b - 0xCC))
    if 0xD4 <= b <= 0xD8:
        code = r.uint(1)
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r, r.uint(1 << (b - 0xD9)), raw)
    if b in (0xDC, 0xDD):
        return [_unpack(r, raw) for _ in range(r.uint(2 if b == 0xDC else 4))]
    if b in (0xDE, 0xDF):
        return _map(r, r.uint(2 if b == 0xDE else 4), raw)
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    b = bytes(r.take(n))
    return b if raw else b.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = _unpack(_Reader(data), raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays have no numpy dtype; store float32")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """``flax.serialization.msgpack_restore(data)``'s tree."""
    r = _Reader(data)
    tree = _unpack(r, raw=False)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of trailing data")
    return _unchunk(tree)
