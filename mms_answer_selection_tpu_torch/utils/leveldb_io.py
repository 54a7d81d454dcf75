"""Pure-Python LevelDB read (and minimal write) path.

The reference's DB abstraction reads LMDB or LevelDB
(src/caffe/util/db_leveldb.cpp:23, db.cpp:41 `GetDB`); the rebuild's LMDB
side is `utils/lmdb_io.py`.  This module closes the LevelDB row
(VERDICT round-4 item 8) with a clean-room reader for the on-disk format
(https://github.com/google/leveldb/blob/main/doc/ — log_format.md,
table_format.md, impl.md), enough to ingest any `convert_imageset
--backend leveldb` artifact a stock caffe build produced:

* **CURRENT/MANIFEST**: VersionEdit records (version_edit.cc tags) inside
  a log-format file give the comparator, the live table files per level,
  and the active WAL number.
* **WAL replay** (`NNNNNN.log`): 32 KiB blocks of crc32c-masked records
  (FULL/FIRST/MIDDLE/LAST fragments), each record one WriteBatch
  (8-byte sequence, 4-byte count, then kTypeValue/kTypeDeletion entries).
* **SSTables** (`NNNNNN.ldb`/`.sst`): footer magic + BlockHandles,
  prefix-compressed blocks with restart arrays, per-block crc32c over
  [contents][compression-type byte], none/snappy compression (snappy
  decompressed by a pure-Python decoder), InternalKeys =
  user_key + 8-byte (sequence<<8 | type).
* **Merge semantics**: every (user_key, seq, type) record from the
  memtable replay and every live table is collected and the
  highest-sequence record per user key wins; deletions drop the key —
  LevelDB's read semantics without needing per-level iterator logic
  (rows materialize on the host, same as LmdbReader; Data-layer ingest
  reads everything anyway).

The writer emits a *valid minimal* DB (CURRENT + MANIFEST + WAL, or
`sst=True` to flush rows into one uncompressed level-0 table instead) so
round-trips and the Data-layer feed are testable hermetically; a stock
leveldb build opens these databases.
"""

from __future__ import annotations

import os
import struct

__all__ = ["LevelDbReader", "write_leveldb", "snappy_decompress",
           "crc32c", "crc32c_mask", "crc32c_unmask"]

# --------------------------------------------------------------- crc32c
_CRC_POLY = 0x82F63B78
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC_POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)
_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c_mask(crc: int) -> int:
    """leveldb stores crcs masked so crcs-of-crcs stay well distributed
    (util/crc32c.h Mask)."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def crc32c_unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# --------------------------------------------------------------- varints
def _uvarint(buf, pos: int):
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _put_uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


# --------------------------------------------------------------- snappy
def snappy_decompress(buf: bytes) -> bytes:
    """Raw-format snappy (the only compression leveldb uses)."""
    n, pos = _uvarint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 0x3
        if kind == 0:                                  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos: pos + nb], "little")
                pos += nb
            ln += 1
            out += buf[pos: pos + ln]
            pos += ln
        else:                                          # copy
            if kind == 1:
                ln = ((tag >> 2) & 0x7) + 4
                off = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[pos: pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[pos: pos + 4], "little")
                pos += 4
            if off == 0 or off > len(out):
                raise ValueError("snappy: bad copy offset")
            start = len(out) - off
            for i in range(ln):                        # may self-overlap
                out.append(out[start + i])
    if len(out) != n:
        raise ValueError(f"snappy: declared {n} bytes, got {len(out)}")
    return bytes(out)


# ------------------------------------------------------------ log format
_LOG_BLOCK = 32768
_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4


def _read_log_records(data: bytes):
    """Yield the records of a leveldb log-format file (WAL or MANIFEST),
    reassembling FIRST/MIDDLE/LAST fragments and checking crcs."""
    pos, partial = 0, None
    while pos + 7 <= len(data):
        block_left = _LOG_BLOCK - pos % _LOG_BLOCK
        if block_left < 7:                             # block trailer
            pos += block_left
            continue
        crc, length, rtype = struct.unpack_from("<IHB", data, pos)
        if rtype == 0 and length == 0 and crc == 0:    # preallocated zero
            pos += block_left                          # rest of the block
            continue
        frag = data[pos + 7: pos + 7 + length]
        if len(frag) < length:
            break                                      # truncated tail
        expect = crc32c_mask(crc32c(bytes([rtype]) + frag))
        if crc != expect:
            raise ValueError(f"log record crc mismatch at {pos}")
        pos += 7 + length
        if rtype == _FULL:
            yield frag
        elif rtype == _FIRST:
            partial = bytearray(frag)
        elif rtype in (_MIDDLE, _LAST):
            if partial is None:
                raise ValueError("orphan log fragment")
            partial += frag
            if rtype == _LAST:
                yield bytes(partial)
                partial = None
        else:
            raise ValueError(f"unknown log record type {rtype}")


def _write_log(records) -> bytes:
    out = bytearray()
    for rec in records:
        rec = bytes(rec)
        first = True
        while True:
            block_left = _LOG_BLOCK - len(out) % _LOG_BLOCK
            if block_left < 7:
                out += b"\x00" * block_left
                block_left = _LOG_BLOCK
            avail = block_left - 7
            frag, rec = rec[:avail], rec[avail:]
            done = not rec
            rtype = (_FULL if first and done else _FIRST if first
                     else _LAST if done else _MIDDLE)
            crc = crc32c_mask(crc32c(bytes([rtype]) + frag))
            out += struct.pack("<IHB", crc, len(frag), rtype) + frag
            first = False
            if done:
                break
    return bytes(out)


# ------------------------------------------------------------ WriteBatch
_TYPE_DELETION, _TYPE_VALUE = 0, 1


def _decode_batch(rec: bytes):
    """WriteBatch bytes -> yields (seq, type, key, value|None)."""
    seq, count = struct.unpack_from("<QI", rec, 0)
    pos = 12
    for i in range(count):
        t = rec[pos]
        pos += 1
        kl, pos = _uvarint(rec, pos)
        key = rec[pos: pos + kl]
        pos += kl
        if t == _TYPE_VALUE:
            vl, pos = _uvarint(rec, pos)
            val = rec[pos: pos + vl]
            pos += vl
        elif t == _TYPE_DELETION:
            val = None
        else:
            raise ValueError(f"unknown WriteBatch entry type {t}")
        yield seq + i, t, key, val


def _encode_batch(seq: int, entries) -> bytes:
    out = bytearray(struct.pack("<QI", seq, len(entries)))
    for key, val in entries:
        if val is None:
            out += bytes([_TYPE_DELETION]) + _put_uvarint(len(key)) + key
        else:
            out += (bytes([_TYPE_VALUE]) + _put_uvarint(len(key)) + key
                    + _put_uvarint(len(val)) + val)
    return bytes(out)


# --------------------------------------------------------------- tables
_TABLE_MAGIC = 0xDB4775248B80FB57


def _parse_block(raw: bytes):
    """Block contents -> yields (key, value) via restart/prefix decoding."""
    if len(raw) < 4:
        raise ValueError("short block")
    n_restarts = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    limit = len(raw) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _uvarint(raw, pos)
        non_shared, pos = _uvarint(raw, pos)
        value_len, pos = _uvarint(raw, pos)
        key = key[:shared] + raw[pos: pos + non_shared]
        pos += non_shared
        yield key, raw[pos: pos + value_len]
        pos += value_len


def _read_table_block(data: bytes, offset: int, size: int) -> bytes:
    contents = data[offset: offset + size]
    ctype = data[offset + size]
    stored = struct.unpack_from("<I", data, offset + size + 1)[0]
    expect = crc32c_mask(crc32c(data[offset: offset + size + 1]))
    if stored != expect:
        raise ValueError(f"table block crc mismatch at {offset}")
    if ctype == 0:
        return contents
    if ctype == 1:
        return snappy_decompress(contents)
    raise ValueError(f"unsupported block compression {ctype}")


def _read_sstable(path: str):
    """Yield (seq, type, user_key, value) for every entry of an .ldb/.sst
    file (table_format.md)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"{path}: too short for an sstable")
    footer = data[-48:]
    if struct.unpack_from("<Q", footer, 40)[0] != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad sstable magic")
    pos = 0
    _mi_off, pos = _uvarint(footer, pos)
    _mi_size, pos = _uvarint(footer, pos)
    idx_off, pos = _uvarint(footer, pos)
    idx_size, pos = _uvarint(footer, pos)
    index = _read_table_block(data, idx_off, idx_size)
    for _sep, handle in _parse_block(index):
        hpos = 0
        b_off, hpos = _uvarint(handle, hpos)
        b_size, hpos = _uvarint(handle, hpos)
        block = _read_table_block(data, b_off, b_size)
        for ikey, value in _parse_block(block):
            if len(ikey) < 8:
                raise ValueError(f"{path}: internal key too short")
            trailer = int.from_bytes(ikey[-8:], "little")
            seq, t = trailer >> 8, trailer & 0xFF
            yield seq, t, ikey[:-8], value


def _write_sstable(path: str, rows, seq_of) -> int:
    """rows: sorted (key, value) pairs; seq_of(key) -> sequence.  Writes
    an uncompressed single-level table; returns the file size."""
    out = bytearray()

    def emit_block(entries):
        """entries: list of (key, value); returns BlockHandle bytes."""
        start = len(out)
        restarts = []
        prev = b""
        for i, (k, v) in enumerate(entries):
            if i % 16 == 0:
                restarts.append(len(out) - start)
                shared = 0
            else:
                shared = 0
                while (shared < len(prev) and shared < len(k)
                       and prev[shared] == k[shared]):
                    shared += 1
            out.extend(_put_uvarint(shared))
            out.extend(_put_uvarint(len(k) - shared))
            out.extend(_put_uvarint(len(v)))
            out.extend(k[shared:])
            out.extend(v)
            prev = k
        for r in restarts:
            out.extend(struct.pack("<I", r))
        out.extend(struct.pack("<I", len(restarts)))
        size = len(out) - start
        crc = crc32c_mask(crc32c(bytes(out[start:]) + b"\x00"))
        out.extend(b"\x00")                      # compression: none
        out.extend(struct.pack("<I", crc))
        return _put_uvarint(start) + _put_uvarint(size)

    data_handles = []                            # (last_internal_key, handle)
    block: list = []
    block_bytes = 0
    for key, value in rows:
        ikey = key + struct.pack("<Q", (seq_of(key) << 8) | _TYPE_VALUE)
        block.append((ikey, value))
        block_bytes += len(ikey) + len(value) + 8
        if block_bytes >= 4096:
            data_handles.append((block[-1][0], emit_block(block)))
            block, block_bytes = [], 0
    if block:
        data_handles.append((block[-1][0], emit_block(block)))
    meta_handle = emit_block([])                 # empty metaindex
    index_handle = emit_block(
        [(last, handle) for last, handle in data_handles])
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out.extend(footer)
    with open(path, "wb") as f:
        f.write(out)
    return len(out)


# ---------------------------------------------------------- VersionEdit
_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQ = 4
_TAG_COMPACT_PTR = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG = 9


def _decode_version_edit(rec: bytes) -> dict:
    pos = 0
    edit = {"new_files": [], "deleted_files": []}
    while pos < len(rec):
        tag, pos = _uvarint(rec, pos)
        if tag == _TAG_COMPARATOR:
            ln, pos = _uvarint(rec, pos)
            edit["comparator"] = rec[pos: pos + ln].decode()
            pos += ln
        elif tag in (_TAG_LOG_NUMBER, _TAG_NEXT_FILE, _TAG_LAST_SEQ,
                     _TAG_PREV_LOG):
            v, pos = _uvarint(rec, pos)
            edit[{_TAG_LOG_NUMBER: "log_number", _TAG_NEXT_FILE:
                  "next_file", _TAG_LAST_SEQ: "last_seq",
                  _TAG_PREV_LOG: "prev_log"}[tag]] = v
        elif tag == _TAG_COMPACT_PTR:
            _lvl, pos = _uvarint(rec, pos)
            ln, pos = _uvarint(rec, pos)
            pos += ln
        elif tag == _TAG_DELETED_FILE:
            lvl, pos = _uvarint(rec, pos)
            num, pos = _uvarint(rec, pos)
            edit["deleted_files"].append((lvl, num))
        elif tag == _TAG_NEW_FILE:
            lvl, pos = _uvarint(rec, pos)
            num, pos = _uvarint(rec, pos)
            size, pos = _uvarint(rec, pos)
            ln, pos = _uvarint(rec, pos)
            pos += ln                             # smallest key
            ln, pos = _uvarint(rec, pos)
            pos += ln                             # largest key
            edit["new_files"].append((lvl, num, size))
        else:
            raise ValueError(f"unknown VersionEdit tag {tag}")
    return edit


def _encode_version_edit(*, comparator=None, log_number=None,
                         next_file=None, last_seq=None,
                         new_files=()) -> bytes:
    out = bytearray()
    if comparator is not None:
        c = comparator.encode()
        out += _put_uvarint(_TAG_COMPARATOR) + _put_uvarint(len(c)) + c
    if log_number is not None:
        out += _put_uvarint(_TAG_LOG_NUMBER) + _put_uvarint(log_number)
    if next_file is not None:
        out += _put_uvarint(_TAG_NEXT_FILE) + _put_uvarint(next_file)
    if last_seq is not None:
        out += _put_uvarint(_TAG_LAST_SEQ) + _put_uvarint(last_seq)
    for lvl, num, size, smallest, largest in new_files:
        out += (_put_uvarint(_TAG_NEW_FILE) + _put_uvarint(lvl)
                + _put_uvarint(num) + _put_uvarint(size)
                + _put_uvarint(len(smallest)) + smallest
                + _put_uvarint(len(largest)) + largest)
    return bytes(out)


# ---------------------------------------------------------------- reader
class LevelDbReader:
    """Read-only view of a LevelDB directory: CURRENT -> MANIFEST ->
    live tables + WAL replay, merged to the highest-sequence record per
    user key (deletions drop keys).  ``items()`` yields (key, value) in
    bytewise key order — the reference cursor's visit order
    (db_leveldb.cpp SeekToFirst/Next over BytewiseComparator)."""

    def __init__(self, path: str):
        self.path = path
        cur = os.path.join(path, "CURRENT")
        if not os.path.exists(cur):
            raise ValueError(f"{path!r} is not a LevelDB directory "
                             f"(no CURRENT file)")
        with open(cur) as f:
            manifest = f.read().strip()
        with open(os.path.join(path, manifest), "rb") as f:
            mdata = f.read()
        comparator = None
        log_number = 0
        files: dict = {}                         # number -> level
        for rec in _read_log_records(mdata):
            edit = _decode_version_edit(rec)
            comparator = edit.get("comparator", comparator)
            log_number = edit.get("log_number", log_number)
            for lvl, num, _size in edit["new_files"]:
                files[num] = lvl
            for _lvl, num in edit["deleted_files"]:
                files.pop(num, None)
        if comparator not in (None, "leveldb.BytewiseComparator"):
            raise ValueError(f"unsupported comparator {comparator!r}")

        best: dict = {}                          # key -> (seq, type, value)

        def apply(seq, t, key, val):
            old = best.get(key)
            if old is None or seq >= old[0]:
                best[key] = (seq, t, val)

        for num, _lvl in sorted(files.items()):
            for ext in (".ldb", ".sst"):
                tpath = os.path.join(path, f"{num:06d}{ext}")
                if os.path.exists(tpath):
                    for seq, t, key, val in _read_sstable(tpath):
                        apply(seq, t, key, val)
                    break
            else:
                raise ValueError(f"live table {num:06d} missing in {path}")
        # WAL replay: every log at/after the manifest's active number
        logs = sorted(int(fn[:6]) for fn in os.listdir(path)
                      if fn.endswith(".log"))
        for num in logs:
            if num < log_number:
                continue                         # obsolete, pre-flush WAL
            with open(os.path.join(path, f"{num:06d}.log"), "rb") as f:
                for rec in _read_log_records(f.read()):
                    for seq, t, key, val in _decode_batch(rec):
                        apply(seq, t, key, val)
        self._rows = [(k, v) for k, (_s, t, v) in sorted(best.items())
                      if t == _TYPE_VALUE]

    def __len__(self):
        return len(self._rows)

    def items(self):
        yield from self._rows

    def keys(self):
        for k, _v in self._rows:
            yield k

    def values(self):
        for _k, v in self._rows:
            yield v


# ---------------------------------------------------------------- writer
def write_leveldb(path: str, items, *, sst: bool = False,
                  batch_size: int = 64):
    """Write (key, value) pairs as a valid minimal LevelDB directory.

    sst=False (default): rows live in the WAL (what a stock leveldb
    produces for small DBs that close before a memtable flush).
    sst=True: rows are flushed into ONE uncompressed level-0 table and
    the WAL is empty — exercises a real caffe artifact's table path.
    Rows need not be pre-sorted; keys must be unique."""
    rows = sorted((bytes(k), bytes(v)) for k, v in items)
    if len({k for k, _ in rows}) != len(rows):
        raise ValueError("duplicate keys")
    os.makedirs(path, exist_ok=True)
    last_seq = len(rows)
    if sst:
        seqs = {k: i + 1 for i, (k, _v) in enumerate(rows)}
        size = _write_sstable(os.path.join(path, "000004.ldb"), rows,
                              lambda k: seqs[k])
        smallest = (rows[0][0] + struct.pack(
            "<Q", (seqs[rows[0][0]] << 8) | _TYPE_VALUE)) if rows else b""
        largest = (rows[-1][0] + struct.pack(
            "<Q", (seqs[rows[-1][0]] << 8) | _TYPE_VALUE)) if rows else b""
        new_files = [(0, 4, size, smallest, largest)] if rows else []
        log_number, next_file = 5, 6
        with open(os.path.join(path, "000005.log"), "wb") as f:
            f.write(b"")
    else:
        new_files = []
        log_number, next_file = 3, 4
        recs = []
        seq = 1
        for a in range(0, len(rows), batch_size):
            chunk = rows[a: a + batch_size]
            recs.append(_encode_batch(seq, chunk))
            seq += len(chunk)
        with open(os.path.join(path, "000003.log"), "wb") as f:
            f.write(_write_log(recs))
    edit = _encode_version_edit(
        comparator="leveldb.BytewiseComparator", log_number=log_number,
        next_file=next_file, last_seq=last_seq, new_files=new_files)
    with open(os.path.join(path, "MANIFEST-000002"), "wb") as f:
        f.write(_write_log([edit]))
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("MANIFEST-000002\n")
    return path
