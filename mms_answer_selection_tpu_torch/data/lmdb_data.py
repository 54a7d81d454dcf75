"""`Data`-layer source: an LMDB of Datums, read sequentially.

The reference's DataLayer pulls Datums off a DataReader cursor in key
order, wrapping at the end (data_layer.cpp:29-112,
data_reader.cpp:79-117), and pushes each through the DataTransformer
(scale / mean / crop / mirror — data_transformer.cpp:19-162).  Here the
cursor is `utils.lmdb_io.LmdbReader`, the transform is the shared
`data.pair_image.transform` (HWC convention), and batches come out
NHWC float32 — the framework's device layout.  Each batch opens two
spans (``utils/timer.py``): ``feed.read``, the Datums' get and parse, then
``feed.transform``, their transform into the batch.
"""

from __future__ import annotations

import numpy as np

from ..utils.io import datum_label, datum_to_array
from ..utils.lmdb_io import LmdbReader
from ..utils.timer import span
from .pair_image import transform

__all__ = ["LmdbDatumDataset", "LevelDbDatumDataset", "open_datum_dataset"]


class LmdbDatumDataset:
    """Iterate {data: (N, H, W, C) float32, label: (N,) int32} batches
    forever, in LMDB key order with wrap-around.

    rand_skip: skip a uniform [0, rand_skip) prefix once at startup
    (data_layer.cpp:41-48 — de-syncs data-parallel solvers).
    """

    _READER = LmdbReader

    def __init__(self, source: str, batch_size: int, *, scale: float = 1.0,
                 mean=None, crop_size: int = 0, mirror: bool = False,
                 train: bool = True, rand_skip: int = 0, seed: int = 0):
        reader = self._READER(source)
        # values held as raw Datum bytes (decoded per batch): one pass,
        # key order — the reference cursor's exact visit order
        self._rows = [bytes(v) for _k, v in reader.items()]
        if not self._rows:
            raise ValueError(f"LMDB {source!r} holds no entries")
        self.batch_size = int(batch_size)
        self._rng = np.random.default_rng(seed)
        self._tf = dict(scale=scale, mean=mean, crop_size=crop_size,
                        mirror=mirror, train=train)
        self._pos = int(self._rng.integers(0, rand_skip)) % len(self._rows) \
            if rand_skip else 0

    def __len__(self):
        return len(self._rows)

    def __iter__(self):
        return self

    def __next__(self):
        with span("feed.read"):
            chws, labels = [], []
            for _ in range(self.batch_size):
                datum = self._rows[self._pos]
                chws.append(datum_to_array(datum))
                labels.append(datum_label(datum))
                self._pos = (self._pos + 1) % len(self._rows)
        with span("feed.transform"):
            crop = self._tf["crop_size"]
            c, h, w = chws[0].shape
            data = np.empty((len(chws),) + ((crop, crop) if crop else (h, w))
                            + (c,), np.float32)
            for i, chw in enumerate(chws):
                data[i] = transform(np.transpose(chw, (1, 2, 0)),
                                    rng=self._rng, **self._tf)
            return {"data": data, "label": np.asarray(labels, np.int32)}


class LevelDbDatumDataset(LmdbDatumDataset):
    """The same Data-layer feed over a LevelDB directory
    (db_leveldb.cpp:23; pure-Python reader `utils.leveldb_io`).  Row
    visit order is bytewise key order — identical to the LevelDB
    cursor's SeekToFirst/Next walk."""

    from ..utils.leveldb_io import LevelDbReader as _READER  # noqa: N814


def open_datum_dataset(source: str, batch_size: int, **kw):
    """Backend sniffing like db.cpp:41 GetDB, but from the artifact
    itself: an LMDB environment has a data.mdb (or IS an .mdb file), a
    LevelDB directory has a CURRENT file."""
    import os

    is_lmdb = os.path.exists(
        source if source.endswith(".mdb")
        else os.path.join(source, "data.mdb"))
    if is_lmdb:
        return LmdbDatumDataset(source, batch_size, **kw)
    if os.path.exists(os.path.join(source, "CURRENT")):
        return LevelDbDatumDataset(source, batch_size, **kw)
    raise ValueError(f"{source!r} is neither an LMDB environment "
                     f"(data.mdb) nor a LevelDB directory (CURRENT)")
