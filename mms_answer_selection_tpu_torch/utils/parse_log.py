"""Training-log parser: caffe glog output (or the `solve` command's
logging, which emits the same line shapes) -> train/test row tables + CSV
(counterpart of ``utils/parse_log.py``, a copy).

Equivalent of ``tools/extra/parse_log.py`` (+ ``extract_seconds.py``):
scans for ``Iteration N``, ``lr = X``, and ``Train/Test net output #k:
name = v`` lines, accumulating one row per display block with columns
``NumIters, Seconds, LearningRate, <output names...>``.  Seconds come
from glog timestamps (``I0817 14:03:12.345678``) when present — logs
from this framework's plain logging format simply omit the column.
Leading rows logged before the first lr line backfill from the first
real learning rate (fix_initial_nan_learning_rate, parse_log.py:94-105).
"""

from __future__ import annotations

import csv
import io
import os
import re
from datetime import datetime

_ITER = re.compile(r"Iteration (\d+)")
_LR = re.compile(r"lr = ([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)")
_OUT = re.compile(r"(Train|Test) net output #(\d+): (\S+) = "
                  r"([-+]?[\.\deE+-]+)")
# glog line prefix: I0817 14:03:12.345678 <tid> file:line]
_GLOG_TS = re.compile(r"^[IWEF](\d{2})(\d{2}) (\d{2}):(\d{2}):(\d{2})"
                      r"\.(\d{6})")


def _line_seconds(line: str, year: int):
    m = _GLOG_TS.match(line)
    if not m:
        return None
    mo, d, h, mi, s, us = (int(g) for g in m.groups())
    return datetime(year, mo, d, h, mi, s, us)


def parse_log(text: str, *, year: int | None = None):
    """Log text -> (train_rows, test_rows): lists of dicts with
    NumIters / Seconds / LearningRate / one key per output blob."""
    year = year or datetime.now().year
    iteration = None
    lr = None
    start_dt = None
    rows = {"Train": [], "Test": []}
    current = {"Train": None, "Test": None}
    for line in text.splitlines():
        it = _ITER.search(line)
        if it:
            iteration = int(it.group(1))
        if iteration is None:
            continue  # ignore preamble before the first iteration
        dt = _line_seconds(line, year)
        if dt is not None and start_dt is None:
            start_dt = dt
        m = _LR.search(line)
        if m:
            lr = float(m.group(1))
        m = _OUT.search(line)
        if not m:
            continue
        phase, idx, name, value = (m.group(1), int(m.group(2)),
                                   m.group(3), float(m.group(4)))
        if idx == 0:  # output #0 opens a fresh display block
            row = {"NumIters": iteration}
            if dt is not None and start_dt is not None:
                row["Seconds"] = (dt - start_dt).total_seconds()
            row["LearningRate"] = lr
            rows[phase].append(row)
            current[phase] = row
        if current[phase] is not None:
            current[phase][name] = value
    for rs in rows.values():  # backfill pre-first-lr rows
        first = next((r["LearningRate"] for r in rs
                      if r.get("LearningRate") is not None), None)
        for r in rs:
            if r.get("LearningRate") is None:
                if first is None:
                    r.pop("LearningRate", None)
                else:
                    r["LearningRate"] = first
    return rows["Train"], rows["Test"]


def rows_to_csv(rows) -> str:
    """Row dicts -> CSV text, columns in first-seen order (the
    reference writes csv.DictWriter over the union of keys)."""
    if not rows:
        return ""
    fields: list = []
    for r in rows:
        for k in r:
            if k not in fields:
                fields.append(k)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=fields, restval="")
    w.writeheader()
    w.writerows(rows)
    return buf.getvalue()


def parse_log_file(path: str, *, out_dir: str | None = None):
    """parse_log.py's CLI behavior: write `<log>.train` and `<log>.test`
    CSVs beside the log (or into out_dir); returns the two paths."""
    with open(path) as f:
        text = f.read()
    year = datetime.fromtimestamp(os.path.getmtime(path)).year
    train, test = parse_log(text, year=year)
    base = os.path.basename(path)
    d = out_dir or os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    train_path = os.path.join(d, base + ".train")
    test_path = os.path.join(d, base + ".test")
    with open(train_path, "w") as f:
        f.write(rows_to_csv(train))
    with open(test_path, "w") as f:
        f.write(rows_to_csv(test))
    return train_path, test_path
