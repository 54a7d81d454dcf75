"""HDF5 dataset compatibility (counterpart of ``data/hdf5_compat.py``,
kept line for line): read the reference's data files directly.

The reference's sole QA input path is HDF5DataLayer over a list-file of
chunked .h5 files with datasets question/answer/label/group/overlap_feat
(src/caffe/layers/hdf5_data_layer.cpp:34-44; chunks written by
do_trec_qa_clean.py:236-246).  Users migrating from the reference can point
this loader at their existing artifacts instead of re-running prep.

Gated on h5py availability; the native npz/MMSP paths never need it.
"""

from __future__ import annotations

import os

import numpy as np


def load_hdf5_list(list_file: str) -> dict:
    """Read a reference-style list file (one .h5 path per line) and
    concatenate every dataset across chunks, preserving row order --
    byte-equivalent to HDF5DataLayer's sequential walk."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - env without h5py
        raise ImportError("h5py is required for HDF5 compatibility") from e

    with open(list_file) as f:
        paths = [line.strip() for line in f if line.strip()]
    if not paths:
        raise ValueError(f"empty HDF5 list file {list_file}")
    base = os.path.dirname(os.path.abspath(list_file))
    chunks: dict[str, list[np.ndarray]] = {}
    for path in paths:
        if not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(base, os.path.basename(path))
        with h5py.File(path, "r") as h5:
            for key in h5.keys():
                chunks.setdefault(key, []).append(np.asarray(h5[key]))
    out = {}
    for key, arrs in chunks.items():
        arr = np.concatenate(arrs, axis=0)
        # the reference stores token ids and labels as float64; narrow them
        if key in ("question", "answer", "label", "group"):
            arr = arr.astype(np.int32)
        else:
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


def save_hdf5_chunks(directory: str, phase: str, split: dict,
                     *, chunk_rows: int = 1_000_000) -> str:
    """Write a split in the reference's chunked HDF5 layout
    (<phase>_data<i>.h5 + <phase>.txt list file) so artifacts flow back
    to the reference too.  Chunk files carry the phase so two phases can
    share one directory without clobbering each other (the reference
    sidesteps this with per-phase dirs, do_trec_qa_clean.py:237; readers
    follow the LIST file, so the name is free to be collision-proof)."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("h5py is required for HDF5 compatibility") from e

    os.makedirs(directory, exist_ok=True)
    n = len(split["label"])
    list_path = os.path.join(directory, f"{phase}.txt")
    with open(list_path, "w") as lf:
        for i in range(0, max(n, 1), chunk_rows):
            path = os.path.join(directory,
                                f"{phase}_data{i // chunk_rows}.h5")
            with h5py.File(path, "w") as h5:
                for key, arr in split.items():
                    h5[key] = np.asarray(arr)[i: i + chunk_rows].astype(
                        np.float64 if key != "overlap_feat" else np.float32)
            lf.write(path + "\n")
    return list_path
