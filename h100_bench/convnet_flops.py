"""The work of a layer-graph net, counted from its prototxt's shapes: the
multiply-adds of each Convolution and InnerProduct of one phase, for one
image, with every blob's (C, H, W) inferred layer by layer.  It counts the
same work whatever implements a layer, and reads the text itself (no
parser of the program's).

    macs = forward_macs(text)["total"]        # one image's forward
    flops = train_flops(text)                 # 3 x 2 x macs: forward,
                                              # input and weight gradients

Layers it knows: Data (three channels at the crop), Convolution, Pooling
(Caffe's ceil rule), InnerProduct, Concat (channels), and the
shape-keeping LRN, ReLU and Dropout; SoftmaxWithLoss and Accuracy end a
path.  Any other type raises, so a net it cannot size is never counted
short.
"""

from __future__ import annotations

import math
import re

_TOKEN = re.compile(r'"(?:[^"\\]|\\.)*"|[{}:]|[^\s{}:"]+')
_KEEP = ("LRN", "ReLU", "Dropout")
_ENDS = ("SoftmaxWithLoss", "Accuracy")


def parse(text: str) -> dict:
    """Protobuf text format -> dict; every field a list of its values
    (a message as a dict), in order."""
    tokens = _TOKEN.findall(re.sub(r"#[^\n]*", "", text))
    pos = 0

    def message(end):
        nonlocal pos
        out: dict = {}
        while pos < len(tokens) and tokens[pos] != end:
            key = tokens[pos]
            pos += 1
            if tokens[pos] == ":":
                pos += 1
            if tokens[pos] == "{":
                pos += 1
                value = message("}")
                pos += 1
            else:
                value = tokens[pos].strip('"')
                pos += 1
            out.setdefault(key, []).append(value)
        return out

    return message(None)


def _one(msg: dict, key: str, default=None):
    return msg.get(key, [default])[-1]


def _phase_keeps(layer: dict, phase: str) -> bool:
    rules = layer.get("include", [])
    if rules:
        return any(_one(r, "phase", phase) == phase for r in rules)
    return not any(_one(r, "phase") == phase for r in layer.get("exclude", []))


def _pooled(size: int, k: int, s: int, pad: int) -> int:
    out = -(-(size + 2 * pad - k) // s) + 1
    if pad and (out - 1) * s >= size + pad:
        out -= 1
    return out


def forward_macs(text: str, phase: str = "TRAIN") -> dict:
    """{"total": multiply-adds of one image's forward, "by_layer": {name:
    macs}, "blobs": {name: (C, H, W)}} over the layers of ``phase``."""
    net = parse(text)
    blobs: dict = {}
    by_layer: dict = {}
    for layer in net.get("layer", []):
        if not _phase_keeps(layer, phase):
            continue
        t, name = _one(layer, "type"), _one(layer, "name")
        bottoms, tops = layer.get("bottom", []), layer.get("top", [])
        if t == "Data":
            crop = int(_one(_one(layer, "transform_param", {}),
                            "crop_size", 0))
            if not crop:
                raise ValueError(f"{name}: a Data layer needs crop_size to "
                                 f"be sized from the text")
            blobs[tops[0]] = (3, crop, crop)
            for top in tops[1:]:
                blobs[top] = ()
            continue
        shapes = [blobs[b] for b in bottoms]
        if t == "Convolution":
            p = _one(layer, "convolution_param")
            c, h, w = shapes[0]
            k = int(_one(p, "kernel_size"))
            s, pad = int(_one(p, "stride", 1)), int(_one(p, "pad", 0))
            group, out = int(_one(p, "group", 1)), int(_one(p, "num_output"))
            ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
            by_layer[name] = out * (c // group) * k * k * ho * wo
            blobs[tops[0]] = (out, ho, wo)
        elif t == "InnerProduct":
            out = int(_one(_one(layer, "inner_product_param"), "num_output"))
            by_layer[name] = math.prod(shapes[0]) * out
            blobs[tops[0]] = (out,)
        elif t == "Pooling":
            p = _one(layer, "pooling_param")
            c, h, w = shapes[0]
            k, s = int(_one(p, "kernel_size")), int(_one(p, "stride", 1))
            pad = int(_one(p, "pad", 0))
            blobs[tops[0]] = (c, _pooled(h, k, s, pad), _pooled(w, k, s, pad))
        elif t == "Concat":
            c = sum(sh[0] for sh in shapes)
            if any(sh[1:] != shapes[0][1:] for sh in shapes):
                raise ValueError(f"{name}: concat of {shapes}")
            blobs[tops[0]] = (c,) + shapes[0][1:]
        elif t in _KEEP:
            blobs[tops[0]] = shapes[0]
        elif t in _ENDS:
            for top in tops:
                blobs[top] = ()
        else:
            raise ValueError(f"{name}: no rule for a {t} layer")
    return {"total": sum(by_layer.values()), "by_layer": by_layer,
            "blobs": blobs}


def train_flops(text: str, phase: str = "TRAIN") -> float:
    """One image's training step: the forward's multiply-adds x 2 (an add
    and a multiply), x 3 (the forward, the input gradients and the weight
    gradients)."""
    return 3 * 2 * float(forward_macs(text, phase)["total"])
