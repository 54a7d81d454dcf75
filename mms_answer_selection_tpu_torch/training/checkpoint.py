"""Checkpoint and resume (counterpart of ``training/checkpoint.py``): the
.caffemodel + .solverstate replacement, in the JAX package's layout so a
checkpoint moves between the two packages either way:

    <dir>/<prefix>_iter_<N>/ckpt.msgpack   params + BN state + solver state
    <dir>/<prefix>_iter_<N>/meta.json      step, dev metrics, loop counters

``ckpt.msgpack`` is flax's msgpack format, written and read by this
package's own codec (``utils/msgpack_codec.py``): for the same bundle its
bytes are flax's.  Tensors are saved through ``.detach().cpu().numpy()``;
``load_checkpoint(template=)`` restores into the template's tree,
checking each leaf's shape, onto the template's device and dtype.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..utils import msgpack_codec


def _to_host(tree):
    """Every leaf through ``np.asarray`` (tensors through
    ``.detach().cpu().numpy()``), None kept, as the JAX package's
    ``jax.tree.map(np.asarray, ...)`` does before it serializes."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    if tree is None or isinstance(tree, tuple):
        return tree        # a tuple is refused by the codec, as by flax
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _write_atomic(path: str, data: bytes) -> None:
    """Write to a temp file beside ``path``, then rename: a crash mid-write
    never leaves a truncated file that ``latest_checkpoint`` would pick."""
    d, name = os.path.split(path)
    tmp = os.path.join(d, f".{name}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, bundle, *, prefix: str = "qa",
                    meta: dict | None = None) -> str:
    """bundle: a tree of dicts (params / state / opt_state / ...) whose
    leaves are tensors, arrays or Python scalars.  Returns the path."""
    path = os.path.join(directory, f"{prefix}_iter_{step}")
    os.makedirs(path, exist_ok=True)
    _write_atomic(os.path.join(path, "ckpt.msgpack"),
                  msgpack_codec.packb(_to_host(bundle)))
    _write_atomic(os.path.join(path, "meta.json"),
                  json.dumps({"step": step, **(meta or {})}).encode())
    return path


def restore(template, raw, path: str = ""):
    """flax's ``from_state_dict`` for dict trees, plus a shape check and
    the move of each leaf onto its template tensor's device and dtype."""
    if isinstance(template, dict):
        if not isinstance(raw, dict):
            raise ValueError(f"{path or '/'}: expected a dict in the "
                             f"checkpoint, found {type(raw).__name__}")
        missing = set(template) - set(raw)
        extra = set(raw) - set(template)
        if missing or extra:
            raise ValueError(f"{path or '/'}: keys differ from the template "
                             f"(missing {sorted(missing)}, extra "
                             f"{sorted(extra)})")
        return {k: restore(v, raw[k], f"{path}/{k}")
                for k, v in template.items()}
    if torch.is_tensor(template):
        arr = np.asarray(raw)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(arr.shape)} != "
                             f"template shape {tuple(template.shape)}")
        return torch.as_tensor(np.array(arr), dtype=template.dtype,
                               device=template.device)
    return raw


def load_checkpoint(path: str, template=None):
    """Returns (bundle, meta).  With ``template`` (a tree of dicts of
    tensors) the bundle is restored into the template's tree as tensors on
    its device, each leaf's shape checked; without, raw nested dicts and
    lists of numpy arrays come back."""
    with open(os.path.join(path, "ckpt.msgpack"), "rb") as f:
        raw = msgpack_codec.unpackb(f.read())
    if template is not None:
        raw = restore(template, raw)
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return raw, meta


def copy_matching(template, loaded, *, path=""):
    """Name+shape-checked partial restore, the finetuning semantics of
    Net::CopyTrainedLayersFrom (net.cpp:741-777): a leaf present in both
    with the same shape is copied (onto the template leaf's device and
    dtype), a shape mismatch or a missing name keeps the template's value.
    Returns (merged tree, report) where report maps each leaf path to
    "loaded" | "shape_mismatch" | "missing"."""
    report = {}

    def merge(tpl, src, p):
        if isinstance(tpl, dict):
            return {k: merge(v, src.get(k) if isinstance(src, dict) else None,
                             f"{p}/{k}" if p else str(k))
                    for k, v in tpl.items()}
        if isinstance(tpl, (list, tuple)):
            src_seq = src if isinstance(src, (list, tuple, dict)) else ()
            out = []
            for i, v in enumerate(tpl):
                if isinstance(src_seq, dict):  # msgpack maps of "0", "1", ...
                    sub = src_seq.get(str(i), src_seq.get(i))
                else:
                    sub = src_seq[i] if i < len(src_seq) else None
                out.append(merge(v, sub, f"{p}/{i}"))
            return type(tpl)(out) if isinstance(tpl, tuple) else out
        if src is None:
            report[p] = "missing"
            return tpl
        src_arr = np.asarray(src)
        tpl_shape = getattr(tpl, "shape", None)
        if tpl_shape is not None and tuple(src_arr.shape) != tuple(tpl_shape):
            report[p] = "shape_mismatch"
            return tpl
        report[p] = "loaded"
        if torch.is_tensor(tpl):
            return torch.as_tensor(np.array(src_arr), dtype=tpl.dtype,
                                   device=tpl.device)
        return src_arr.astype(tpl.dtype) if hasattr(tpl, "dtype") else src_arr

    return merge(template, loaded, path), report


def load_weights_into(params, state, ckpt_path: str):
    """`caffe train -weights` (tools/caffe.cpp:125-135, 211-213): a
    checkpoint's params (and BN state when present) into an initialized
    model by name and shape.  Returns (params, state, report)."""
    bundle, _meta = load_checkpoint(ckpt_path)
    params, report = copy_matching(params, bundle.get("params", bundle))
    if state is not None and isinstance(bundle, dict) and "state" in bundle:
        state, state_report = copy_matching(state, bundle["state"])
        report.update({f"state/{k}": v for k, v in state_report.items()})
    return params, state, report


def latest_checkpoint(directory: str, *, prefix: str = "qa") -> str | None:
    """Highest-step checkpoint dir under ``directory`` (resume from a
    snapshot, the `caffe train -snapshot` equivalent)."""
    if not os.path.isdir(directory):
        return None
    best_step, best = -1, None
    pat = re.compile(rf"^{re.escape(prefix)}_iter_(\d+)$")
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(directory, name)
    return best
