"""Batch iteration (counterpart of ``data/loader.py``): the
BasePrefetchingDataLayer/DataReader replacement for in-memory splits.

* deterministic per-epoch reshuffle (HDF5DataLayer shuffle,
  hdf5_data_layer.cpp:55-68): epoch e's order is a numpy permutation
  seeded from ``derive_seed(seed, epoch)`` (the JAX package draws it from
  threefry, so the orders differ; ``shuffle=False`` gives the same batches);
* per-host sharding = deterministic striding by process index (``shard``),
  the DataReader round-robin (data_reader.cpp:79-98) done with arithmetic;
* ``device=`` moves each batch to that device as tensors (the JAX
  package's ``device_put``); without it batches are numpy.

The out-of-core path is ``native/`` (the packed store's prefetch ring).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.seed import derive_seed


class ArrayDataset:
    """A dict of equal-length numpy arrays with slicing."""

    def __init__(self, arrays: dict):
        lens = {k: len(v) for k, v in arrays.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"ragged dataset: {lens}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.size = next(iter(lens.values()))

    def __len__(self):
        return self.size

    def select(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


class BatchIterator:
    """Infinite deterministic batch stream with epoch-wise reshuffle.

    shard=(index, count) stripes rows across hosts like the reference's
    DataReader assigns rows to solvers (data_reader.cpp:79-98).
    """

    def __init__(self, dataset: ArrayDataset, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, shard: tuple[int, int] = (0, 1),
                 drop_keys: tuple = (), device=None):
        self.ds = dataset
        self.bs = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.shard_index, self.shard_count = shard
        self.drop_keys = set(drop_keys)
        self.device = None if device is None else resolve_device(device)
        self.epoch = 0
        self._cursor = 0
        self._perm = self._make_perm()
        if len(self._perm) == 0:
            # an empty stripe would spin __next__ forever (reshuffling
            # never makes it non-empty)
            raise ValueError(
                f"shard {self.shard_index}/{self.shard_count} of a "
                f"{self.ds.size}-row dataset is empty")

    def _make_perm(self):
        idx = np.arange(self.ds.size)
        if self.shuffle:
            rng = np.random.default_rng(derive_seed(self.seed, self.epoch))
            idx = rng.permutation(self.ds.size)
        return idx[self.shard_index:: self.shard_count]

    def __iter__(self):
        return self

    def __next__(self):
        take = []
        need = self.bs
        while need > 0:
            chunk = self._perm[self._cursor: self._cursor + need]
            take.append(chunk)
            self._cursor += len(chunk)
            need -= len(chunk)
            if self._cursor >= len(self._perm):
                self.epoch += 1
                self._perm = self._make_perm()
                self._cursor = 0
        idx = np.concatenate(take) if len(take) > 1 else take[0]
        batch = {k: v for k, v in self.ds.select(idx).items()
                 if k not in self.drop_keys}
        if self.device is not None:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
        return batch
