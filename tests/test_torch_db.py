"""The reference's databases in the port against the JAX package, on CPU:
the LMDB reader and writer (``utils/lmdb_io.py``), the LevelDB reader and
writer (``utils/leveldb_io.py``: crc32c, snappy, the WAL, SSTables), the
Datum feeds (``data/lmdb_data.py``) and ``Data`` layers under
``GraphSolver``.

Held exactly: each package's writer produces the same bytes, each reads
the other's databases to the same rows, and the feeds' batches (Datum
decode, mean, crop, scale; shuffle and mirror off) are equal to the bit.
"""

import os

import numpy as np
import pytest

from mms_answer_selection_tpu.data import lmdb_data as jld
from mms_answer_selection_tpu.training.graph_solver import \
    GraphSolver as JGS
from mms_answer_selection_tpu.utils import leveldb_io as jlv
from mms_answer_selection_tpu.utils import lmdb_io as jlm
from mms_answer_selection_tpu.utils.io import array_to_datum as j_datum
from mms_answer_selection_tpu_torch.data import lmdb_data as tld
from mms_answer_selection_tpu_torch.training.graph_solver import \
    GraphSolver as TGS
from mms_answer_selection_tpu_torch.utils import leveldb_io as tlv
from mms_answer_selection_tpu_torch.utils import lmdb_io as tlm
from mms_answer_selection_tpu_torch.utils.caffemodel import \
    save_blob_binaryproto
from mms_answer_selection_tpu_torch.utils.io import array_to_datum


def _rows(kind, n=None):
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return []
    if kind == "small":
        return [(f"k{i:03d}".encode(), f"value-{i}".encode() * (i % 5 + 1))
                for i in range(20)]
    if kind == "btree":       # leaves and a branch level
        return [(f"{i:06d}".encode(), rng.bytes(120)) for i in range(2000)]
    if kind == "overflow":    # values past a page, some of several pages
        return [(b"a", b"small"), (b"b", rng.bytes(3000)),
                (b"c", rng.bytes(20000)), (b"d", b"also-small")]
    if kind == "unsorted":
        return [(b"zz", b"1"), (b"aa", b"2"), (b"mm", b"3")]
    if kind == "datums":
        imgs = rng.integers(0, 256, (64, 3, 8, 6), dtype=np.uint8)
        return [(f"{i:08d}_img{i}.png".encode(), array_to_datum(imgs[i],
                                                               i % 7))
                for i in range(len(imgs))]
    raise AssertionError(kind)


KINDS = ["empty", "small", "btree", "overflow", "unsorted", "datums"]


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("kind", KINDS)
def test_lmdb_writer_bytes_equal_jax(tmp_path, kind):
    rows = _rows(kind)
    jlm.write_lmdb(str(tmp_path / "j"), rows)
    tlm.write_lmdb(str(tmp_path / "t"), rows)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("kind", KINDS)
def test_lmdb_each_reads_the_other(tmp_path, kind):
    rows = _rows(kind)
    jlm.write_lmdb(str(tmp_path / "j"), rows)
    tlm.write_lmdb(str(tmp_path / "t"), rows)
    for path in (tmp_path / "j", tmp_path / "t"):
        j, t = jlm.LmdbReader(str(path)), tlm.LmdbReader(str(path))
        assert list(t.items()) == list(j.items()) == sorted(rows)
        assert (len(t), t.depth, t.branch_pages, t.leaf_pages,
                t.overflow_pages) == (len(j), j.depth, j.branch_pages,
                                      j.leaf_pages, j.overflow_pages)


@pytest.mark.parametrize("sst", [False, True])
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "empty"])
def test_leveldb_writer_bytes_equal_jax(tmp_path, kind, sst):
    rows = _rows(kind)
    jlv.write_leveldb(str(tmp_path / "j"), rows, sst=sst)
    tlv.write_leveldb(str(tmp_path / "t"), rows, sst=sst)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("sst", [False, True])
@pytest.mark.parametrize("kind", [k for k in KINDS if k != "empty"])
def test_leveldb_each_reads_the_other(tmp_path, kind, sst):
    rows = _rows(kind)
    jlv.write_leveldb(str(tmp_path / "j"), rows, sst=sst)
    tlv.write_leveldb(str(tmp_path / "t"), rows, sst=sst)
    for path in (tmp_path / "j", tmp_path / "t"):
        j, t = jlv.LevelDbReader(str(path)), tlv.LevelDbReader(str(path))
        assert list(t.items()) == list(j.items()) == sorted(rows)


@pytest.mark.parametrize("data", [b"", b"123456789", bytes(range(256)) * 9,
                                  b"\x00" * 32, b"\xff" * 33])
def test_crc32c_and_masks_equal_jax(data):
    crc = tlv.crc32c(data)
    assert crc == jlv.crc32c(data)
    assert tlv.crc32c_mask(crc) == jlv.crc32c_mask(crc)
    assert tlv.crc32c_unmask(tlv.crc32c_mask(crc)) == crc


@pytest.mark.parametrize("buf", [
    b"\x05\x10hello",                            # one literal
    b"\x0c\x0cabab\x1e\x02\x00",                 # overlapping copy
    bytes([20, 0x0c]) + b"abcd" + bytes([0x3e, 4, 0]) + bytes([0x2e, 4, 0]),
])
def test_snappy_decompress_equals_jax(buf):
    try:
        want = jlv.snappy_decompress(buf)
    except ValueError:
        with pytest.raises(ValueError):
            tlv.snappy_decompress(buf)
        return
    assert tlv.snappy_decompress(buf) == want


def test_wal_records_and_batches_equal_jax():
    recs = [jlv._encode_batch(1, [(b"a", b"1"), (b"b", b"x" * 40000)]),
            jlv._encode_batch(3, [(b"c", b"")])]
    assert [tlv._encode_batch(1, [(b"a", b"1"), (b"b", b"x" * 40000)]),
            tlv._encode_batch(3, [(b"c", b"")])] == recs
    log = jlv._write_log(recs)
    assert tlv._write_log(recs) == log
    assert list(tlv._read_log_records(log)) == list(jlv._read_log_records(log))
    assert [list(tlv._decode_batch(r)) for r in recs] == \
        [list(jlv._decode_batch(r)) for r in recs]


# ---------------------------------------------------------------- feeds

def _datum_db(tmp_path, backend, n=24, hw=(10, 8)):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (n, 3) + hw, dtype=np.uint8)
    rows = [(f"{i:08d}_x".encode(), j_datum(imgs[i], i % 5))
            for i in range(n)]
    path = str(tmp_path / backend)
    if backend == "lmdb":
        jlm.write_lmdb(path, rows)
    else:
        jlv.write_leveldb(path, rows, sst=True)
    return path, imgs


TRANSFORMS = {
    "plain": dict(),
    "scaled": dict(scale=1 / 256),
    "mean": dict(mean=np.asarray([10.0, 20.0, 30.0], np.float32),
                 scale=0.5),
    "crop_test": dict(crop_size=6, train=False),
    "crop_train": dict(crop_size=5, train=True),
    "skip": dict(rand_skip=7),
    # the transform crops and mirrors before it subtracts: a channel mean
    # and a per-pixel (H, W, C) mean, cropped and flipped with the image
    "mirror_crop_mean": dict(crop_size=5, mirror=True, scale=0.5,
                             mean=np.asarray([10.0, 20.0, 30.0],
                                             np.float32)),
    "mirror_crop_pixel_mean": dict(
        crop_size=6, mirror=True, mean=np.random.default_rng(8).uniform(
            0, 255, (10, 8, 3)).astype(np.float32)),
    "mirror_test": dict(crop_size=6, mirror=True, train=False),
}


@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
@pytest.mark.parametrize("tf", sorted(TRANSFORMS))
def test_datum_feed_batches_equal_jax(tmp_path, backend, tf):
    path, _ = _datum_db(tmp_path, backend)
    kw = dict(TRANSFORMS[tf], seed=3)
    j = jld.open_datum_dataset(path, 5, **kw)
    t = tld.open_datum_dataset(path, 5, **kw)
    assert type(t).__name__ == type(j).__name__
    for _ in range(7):          # wraps around the 24 rows
        jb, tb = next(j), next(t)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_open_datum_dataset_refuses_what_jax_refuses(tmp_path):
    (tmp_path / "x").mkdir()
    for mod in (jld, tld):
        with pytest.raises(ValueError, match="neither"):
            mod.open_datum_dataset(str(tmp_path / "x"), 2)


NET = """
layer {{ name: "d" type: "Data" top: "data" top: "label"
  data_param {{ source: "{src}" batch_size: 4 backend: {backend} }}
  transform_param {{ scale: 0.00390625 {extra} }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  inner_product_param {{ num_output: 5 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
"""


@pytest.mark.parametrize("backend", ["LMDB", "LEVELDB"])
@pytest.mark.parametrize("extra", ["", "crop_size: 6",
                                   'mean_file: "mean.binaryproto"'])
def test_data_layer_batches_under_graph_solver_equal_jax(tmp_path, backend,
                                                         extra):
    path, imgs = _datum_db(tmp_path, backend.lower())
    save_blob_binaryproto(str(tmp_path / "mean.binaryproto"),
                          imgs.mean(0, keepdims=True).astype(np.float32))
    (tmp_path / "net.prototxt").write_text(
        NET.format(src=path, backend=backend, extra=extra))
    (tmp_path / "solver.prototxt").write_text(
        'net: "net.prototxt"\nbase_lr: 0.01\ntype: "SGD"\nmax_iter: 3\n'
        'snapshot_after_train: false\nrandom_seed: 5\n')
    sp = str(tmp_path / "solver.prototxt")
    jgs, tgs = JGS(sp), TGS(sp, device="cpu")
    for _ in range(8):
        jb = jgs._next_batch(jgs._feeds)
        tb = tgs._next_batch(tgs._feeds)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    tgs.step(3)
    assert tgs.iter_ == 3 and np.isfinite(tgs._smoothed)
