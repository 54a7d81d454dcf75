"""Pure-Python LMDB (data.mdb) access: read-only ingest + bulk writer.

The reference packs training Datums into LMDB environments
(src/caffe/util/db_lmdb.cpp:1-113, data_reader.cpp:18-117); this gives
the rebuild a READ path for existing reference artifacts — and a
single-transaction bulk WRITER (the `mdb_load`-style create side
`qa convert_imageset` needs) — without an lmdb runtime package.

Format notes (the public liblmdb `mdb.c`, file version MDB_DATA_VERSION
1, 64-bit layout):

* page header (16 bytes): pgno u64, pad u16, flags u16, lower u16,
  upper u16; overflow pages store their page count as u32 at offset 12.
* meta pages 0 and 1: MDB_meta at offset 16 — magic 0xBEEFC0DE u32,
  version u32, address u64, mapsize u64, MDB_db[2] (FREE, MAIN),
  last_pg u64, txnid u64.  The PAGE SIZE hides in the FREE db's md_pad
  (mdb.c `#define mm_psize mm_dbs[0].md_pad`).  Readers pick the meta
  with the larger txnid.
* MDB_db (48 bytes): pad u32, flags u16, depth u16, branch_pages u64,
  leaf_pages u64, overflow_pages u64, entries u64, root u64
  (root == ~0 means empty).
* node (8-byte header): lo u16, hi u16, flags u16, ksize u16, then key
  bytes.  Branch: child pgno = lo | hi<<16 | flags<<32 (no node flags).
  Leaf: data size = lo | hi<<16; flags bit 0 (F_BIGDATA) means an
  8-byte overflow pgno follows the key instead of inline data, and the
  value spans `OVPAGES(size)` contiguous pages starting there (16-byte
  header on the first page only).
* nodes are 2-byte aligned; mp_ptrs (u16 each, from offset 16) hold
  key-sorted node offsets.  Searches skip branch node 0's key, so
  storing a real key there is harmless.

Scope: the single unnamed database with plain (non-dup) values — all
caffe ever uses.  No locking (readers here never race a live writer).
"""

from __future__ import annotations

import os
import struct

__all__ = ["LmdbReader", "write_lmdb"]

_MAGIC = 0xBEEFC0DE
_VERSION = 1
_HDR = 16
_P_BRANCH, _P_LEAF, _P_OVERFLOW, _P_META = 0x01, 0x02, 0x04, 0x08
_F_BIGDATA = 0x01
_INVALID = 0xFFFFFFFFFFFFFFFF
_PAGE_HDR = struct.Struct("<QHHHH")       # pgno, pad, flags, lower, upper
_DB = struct.Struct("<IHHQQQQQ")          # pad,flags,depth,br,lf,ov,ent,root
_NODE = struct.Struct("<HHHH")            # lo, hi, flags, ksize


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


def _even(n: int) -> int:
    return (n + 1) & ~1


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class LmdbReader:
    """Read-only view of one LMDB environment (a directory holding
    data.mdb, or the .mdb file itself).  ``items()`` iterates
    (key, value) bytes in key order — the order the reference's
    sequential cursor sees (db_lmdb.cpp LMDBCursor::Next)."""

    def __init__(self, path: str):
        p = _data_path(path)
        with open(p, "rb") as f:
            self._buf = f.read()
        if len(self._buf) < 2 * _HDR:
            raise ValueError(f"{p}: too small to be an LMDB data file")
        meta0 = self._read_meta(0, psize=None)
        self.psize = meta0["psize"]
        meta1 = self._read_meta(1, psize=self.psize)
        self._meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        (self._pad, self._flags, self.depth, self.branch_pages,
         self.leaf_pages, self.overflow_pages, self.entries,
         self._root) = self._meta["main"]

    def _read_meta(self, idx: int, psize: int | None) -> dict:
        off = idx * (psize if psize else 4096)
        if psize is None:
            # page size comes FROM the meta (FREE db md_pad); the first
            # meta always starts at 0, so bootstrap from there
            off = 0 if idx == 0 else None
        base = off + _HDR
        magic, version = struct.unpack_from("<II", self._buf, base)
        if magic != _MAGIC:
            raise ValueError(f"meta {idx}: bad magic {magic:#x} "
                             f"(not an LMDB data file)")
        if version != _VERSION:
            raise ValueError(f"meta {idx}: unsupported file version "
                             f"{version}")
        free = _DB.unpack_from(self._buf, base + 24)
        main = _DB.unpack_from(self._buf, base + 24 + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self._buf,
                                            base + 24 + 2 * _DB.size)
        return {"psize": free[0] or 4096, "free": free, "main": main,
                "last_pg": last_pg, "txnid": txnid}

    def __len__(self) -> int:
        return int(self.entries)

    def _page(self, pgno: int):
        off = pgno * self.psize
        return off, _PAGE_HDR.unpack_from(self._buf, off)

    def _walk(self, pgno: int):
        off, (pg, _pad, flags, lower, upper) = self._page(pgno)
        n = (lower - _HDR) // 2
        ptrs = struct.unpack_from(f"<{n}H", self._buf, off + _HDR)
        if flags & _P_BRANCH:
            for ptr in ptrs:
                lo, hi, nflags, _ks = _NODE.unpack_from(self._buf,
                                                        off + ptr)
                yield from self._walk(lo | hi << 16 | nflags << 32)
            return
        if not flags & _P_LEAF:
            raise ValueError(f"page {pgno}: unexpected flags {flags:#x} "
                             f"in the main tree")
        for ptr in ptrs:
            nbase = off + ptr
            lo, hi, nflags, ksize = _NODE.unpack_from(self._buf, nbase)
            dsize = lo | hi << 16
            key = self._buf[nbase + 8:nbase + 8 + ksize]
            if nflags & _F_BIGDATA:
                (ovpg,) = struct.unpack_from("<Q", self._buf,
                                             nbase + 8 + ksize)
                dstart = ovpg * self.psize + _HDR
                yield key, self._buf[dstart:dstart + dsize]
            else:
                dstart = nbase + 8 + ksize
                yield key, self._buf[dstart:dstart + dsize]

    def items(self):
        """(key, value) bytes pairs in key order."""
        if self._root == _INVALID:
            return
        yield from self._walk(self._root)

    def keys(self):
        for k, _v in self.items():
            yield k

    def values(self):
        for _k, v in self.items():
            yield v


# ---------------------------------------------------------------------------
# bulk writer
# ---------------------------------------------------------------------------

def write_lmdb(path: str, items, *, psize: int = 4096,
               map_size: int | None = None) -> str:
    """Write ``items`` (iterable of (key, value) bytes pairs; sorted
    here) as one complete LMDB environment — the single-commit shape
    `convert_imageset` produces.  ``path``: a directory (creates
    ``data.mdb`` inside, like mdb_env_open without MDB_NOSUBDIR) or an
    explicit ``.mdb`` file path.  Returns the data file path."""
    rows = sorted((bytes(k), bytes(v)) for k, v in items)
    for k, _v in rows:
        if len(k) > 511:  # liblmdb's default MDB_MAXKEYSIZE
            raise ValueError(f"key of {len(k)} bytes exceeds LMDB's "
                             f"511-byte key limit")
    pages: dict[int, bytearray] = {}
    next_pg = [2]

    def alloc() -> int:
        n = next_pg[0]
        next_pg[0] += 1
        pages[n] = bytearray(psize)
        return n

    # mdb's me_nodemax: an inline leaf node must leave room for
    # MDB_MINKEYS (2) nodes per page
    nodemax = ((psize - _HDR) // 2) & ~1
    n_overflow = 0

    def overflow_write(value: bytes) -> int:
        nonlocal n_overflow
        npages = (_HDR + len(value) + psize - 1) // psize
        first = next_pg[0]
        raw = bytearray(npages * psize)
        _PAGE_HDR.pack_into(raw, 0, first, 0, _P_OVERFLOW, 0, 0)
        struct.pack_into("<I", raw, 12, npages)
        raw[_HDR:_HDR + len(value)] = value
        for i in range(npages):
            pages[next_pg[0]] = raw[i * psize:(i + 1) * psize]
            next_pg[0] += 1
        n_overflow += npages
        return first

    def fill_pages(nodes, flags):
        """Pack (key, node_bytes) rows into pages; returns
        [(first_key, pgno), ...]."""
        out = []
        cur: list[tuple[bytes, bytes]] = []
        lower, upper = _HDR, psize

        def flush():
            nonlocal cur, lower, upper
            pg = alloc()
            buf = pages[pg]
            offs = []
            top = psize
            for _k, nb in cur:
                top -= _even(len(nb))
                buf[top:top + len(nb)] = nb
                offs.append(top)
            _PAGE_HDR.pack_into(buf, 0, pg, 0, flags,
                                _HDR + 2 * len(cur), top)
            struct.pack_into(f"<{len(cur)}H", buf, _HDR, *offs)
            out.append((cur[0][0], pg))
            cur, lower, upper = [], _HDR, psize

        for key, nb in nodes:
            need = 2 + _even(len(nb))  # ptr slot + aligned node
            if cur and lower + need > upper:
                flush()
            lower += 2
            upper -= _even(len(nb))
            cur.append((key, nb))
        if cur:
            flush()
        return out

    def leaf_node(key: bytes, value: bytes) -> bytes:
        if 8 + len(key) + len(value) <= nodemax:
            return _NODE.pack(len(value) & 0xFFFF, len(value) >> 16, 0,
                              len(key)) + key + value
        ovpg = overflow_write(value)
        return _NODE.pack(len(value) & 0xFFFF, len(value) >> 16,
                          _F_BIGDATA, len(key)) + key \
            + struct.pack("<Q", ovpg)

    def branch_node(key: bytes, pgno: int) -> bytes:
        return _NODE.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                          pgno >> 32, len(key)) + key

    n_branch = 0
    if rows:
        level = fill_pages(((k, leaf_node(k, v)) for k, v in rows),
                           _P_LEAF)
        n_leaf, depth = len(level), 1
        while len(level) > 1:
            level = fill_pages(((k, branch_node(k, pg))
                                for k, pg in level), _P_BRANCH)
            n_branch += len(level)
            depth += 1
        root = level[0][1]
    else:
        n_leaf, depth, root = 0, 0, _INVALID

    last_pg = next_pg[0] - 1
    file_size = (last_pg + 1) * psize
    if map_size is None:
        map_size = max(1 << 20, file_size)

    main_db = _DB.pack(0, 0, depth, n_branch, n_leaf, n_overflow,
                       len(rows), root)
    free_db = _DB.pack(psize, 0x08, 0, 0, 0, 0, 0, _INVALID)  # INTEGERKEY
    meta_tail = main_db + struct.pack("<QQ", last_pg, 1)  # txnid 1

    if path.endswith(".mdb"):
        out_path = path
    else:  # directory environment, like mdb_env_open without NOSUBDIR
        os.makedirs(path, exist_ok=True)
        out_path = os.path.join(path, "data.mdb")
    with open(out_path, "wb") as f:
        for idx in (0, 1):
            page = bytearray(psize)
            _PAGE_HDR.pack_into(page, 0, idx, 0, _P_META, 0, 0)
            struct.pack_into("<IIQQ", page, _HDR, _MAGIC, _VERSION, 0,
                             map_size)
            page[_HDR + 24:_HDR + 24 + len(free_db + meta_tail)] = \
                free_db + meta_tail
            f.write(page)
        for pg in range(2, last_pg + 1):
            f.write(pages[pg])
    return out_path
