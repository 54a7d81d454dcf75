"""Deployment export: one artifact carrying the inference program and the
weights (counterpart of ``deploy.py``).

The reference's frozen deployment pair is a .caffemodel plus a deploy
prototxt that C++ caffe loads without the training scripts
(tools/caffe.cpp:229-296).  Here ``torch.export`` traces the V4 model's
eval forward, (question ids, answer ids, overlap features) -> (logits,
P(class)), with the parameters and BN state baked into the program as its
buffers, and the batch dimension symbolic unless pinned.  A loaded scorer
needs torch and this package's operator registration, not the model code.

The pair maps go through the ``mms_torch::pair_maps_fwd`` operator
(``ops/sim_cross_kernels.py``): on the card the loaded program launches
the hand-written kernel, on the CPU it runs the plain version.

File layout, as the JAX package's: ``MAGIC | uint64 header_len | header
json | program bytes``, the program bytes being ``torch.export.save``'s.
The header carries the shape facts a server needs without reading the
program, the writer's torch version (a program is loaded by the torch
minor version that wrote it), the pair-map route and the platforms the
artifact may be loaded on (``platforms``, as the JAX package's lowering
targets).  The JAX package lowers for ("cpu", "tpu") by default; this
package runs on the CPU and on CUDA cards, so its default is ("cpu",
"cuda"), and a platform it cannot run ("tpu", say) is refused when the
artifact is written.  ``load_scorer`` refuses a device the header does not
name.
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np
import torch

from .device import resolve_device
from .utils.tree import tree_leaves

MAGIC = b"MMSTPRT1"
FORMAT = 1
PAIR_MAP_ROUTE = "custom_op"
PLATFORMS = ("cpu", "cuda")  # the devices its programs run on


def check_platforms(platforms) -> tuple:
    """``platforms`` checked: at least one, each a device type this
    package runs on."""
    names = tuple(str(p) for p in platforms)
    bad = [p for p in names if p not in PLATFORMS]
    if bad or not names:
        raise ValueError(
            f"cannot export for platform(s) {bad or list(names)}: this "
            f"package's programs run on {list(PLATFORMS)}")
    return names


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflat(pairs):
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


class _Scorer(torch.nn.Module):
    """V4's eval forward with the weights as buffers."""

    def __init__(self, params, state, cfg):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for tree, (which, t) in enumerate((("p", params), ("s", state))):
            for i, (path, leaf) in enumerate(_flat(t)):
                name = f"{which}{i}"
                self.register_buffer(name, leaf.detach().clone())
                self._paths.append((tree, path, name))

    def forward(self, question, answer, overlap_feat):
        from .models.mms_qa import mms_qa_apply
        trees = ([], [])
        for tree, path, name in self._paths:
            trees[tree].append((path, getattr(self, name)))
        out, _ = mms_qa_apply(
            _unflat(trees[0]), _unflat(trees[1]),
            {"question": question, "answer": answer,
             "overlap_feat": overlap_feat}, self.cfg, train=False)
        return out["logits"], out["prob"]


def export_scorer(params, state, cfg, *, batch: int | None = None,
                  platforms=PLATFORMS):
    """``torch.export`` of the inference forward with the weights baked
    in, on the device the parameters lie on.  batch: None exports a
    symbolic batch dimension (one program for every request size); an int
    pins it.  platforms: the device types the program is for (checked; one
    program serves each, moved at load)."""
    check_platforms(platforms)
    dev = tree_leaves(params)[0].device
    module = _Scorer(params, state, cfg).eval()
    n = 2 if batch is None else int(batch)
    args = (torch.zeros((n, cfg.question_len), dtype=torch.int64, device=dev),
            torch.zeros((n, cfg.answer_len), dtype=torch.int64, device=dev),
            torch.zeros((n, cfg.overlap_features), dtype=torch.float32,
                        device=dev))
    dynamic = None
    if batch is None:
        b = torch.export.Dim("batch", min=1)
        dynamic = ({0: b}, {0: b}, {0: b})
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic)


def save_scorer(path: str, params, state, cfg, *,
                batch: int | None = None, platforms=PLATFORMS) -> dict:
    """Export and write the artifact; returns the header dict, whose
    ``platforms`` lists the devices ``load_scorer`` will load it on."""
    platforms = check_platforms(platforms)
    program = export_scorer(params, state, cfg, batch=batch,
                            platforms=platforms)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    header = {
        "format": FORMAT,
        "question_len": int(cfg.question_len),
        "answer_len": int(cfg.answer_len),
        "overlap_features": int(cfg.overlap_features),
        "vocab_size": int(cfg.vocab_size),
        "batch": batch,
        "platforms": list(platforms),
        "device": tree_leaves(params)[0].device.type,
        "torch": torch.__version__,
        "pair_maps": PAIR_MAP_ROUTE,
        "outputs": ["logits", "prob"],
        "bytes": len(blob),
    }
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        f.write(blob)
    return header


def _minor(version: str) -> tuple:
    return tuple(version.split("+")[0].split(".")[:2])


class LoadedScorer:
    """A loaded deployment artifact on ``device`` (``None`` means CUDA; the
    CPU runs only when asked for).  Calls take host or device arrays and
    return host (logits, prob) numpy arrays."""

    def __init__(self, header: dict, program, *, device=None):
        self.header = header
        self.device = resolve_device(device)
        if header.get("device") != self.device.type:
            from torch.export.passes import move_to_device_pass
            program = move_to_device_pass(program, self.device)
        self.program = program
        self._module = program.module()

    def _tensor(self, x, dtype):
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.device, dtype)

    def __call__(self, question, answer, overlap_feat):
        # the program's convolutions are plain aten calls: the float32
        # accumulation ``ops/conv.py`` asks cuDNN for is asked again here
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            logits, prob = self._module(
                self._tensor(question, torch.int64),
                self._tensor(answer, torch.int64),
                self._tensor(overlap_feat, torch.float32))
        return logits.cpu().numpy(), prob.cpu().numpy()

    def score(self, question, answer, overlap_feat) -> np.ndarray:
        """P(correct): the positive-class probability column."""
        return self(question, answer, overlap_feat)[1][:, 1]


def read_header(path: str) -> tuple[dict, bytes]:
    """(header, program bytes) of an artifact, checked: the magic, the
    format and the program's length."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not an exported scorer "
                             f"(bad magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        blob = f.read()
    if header.get("format") != FORMAT:
        raise ValueError(f"unsupported artifact format {header.get('format')}")
    if len(blob) != header["bytes"]:
        raise ValueError(f"truncated artifact: header promises "
                         f"{header['bytes']} program bytes, found "
                         f"{len(blob)}")
    return header, blob


def load_scorer(path: str, *, device=None) -> LoadedScorer:
    """Read an artifact written by ``save_scorer``.  Refuses a bad magic,
    format or length, a device type the header's ``platforms`` do not
    name, and a program written by another torch minor version."""
    from .ops import sim_cross_kernels  # noqa: F401  registers the operator
    header, blob = read_header(path)
    named = header.get("platforms", list(PLATFORMS))
    kind = torch.device("cuda" if device is None else device).type
    if kind not in named:
        raise ValueError(f"{path} was exported for {named}, not {kind!r}: "
                         f"export it again with --platforms")
    if _minor(header.get("torch", "")) != _minor(torch.__version__):
        raise ValueError(
            f"artifact was written by torch {header.get('torch')}; this is "
            f"torch {torch.__version__}, and an exported program loads only "
            f"in the torch minor version that wrote it: export it again")
    program = torch.export.load(io.BytesIO(blob))
    return LoadedScorer(header, program, device=device)
