"""Net-structure visualization: prototxt -> Graphviz DOT text.

The reference ships ``python/caffe/draw.py`` (get_pydot_graph +
``python/draw_net.py``): layer nodes as boxes labeled with the type and
its headline hyperparameters, blob nodes as octagons, edges
bottom-blob -> layer -> top-blob, with TRAIN/TEST phase filtering.  This
emits the same graph as plain DOT text (no pydot/graphviz runtime
needed — any `dot` renderer or online viewer consumes the file), built
on the same parsed-and-upgraded NetParameter GraphNet executes.
"""

from __future__ import annotations

from .prototxt import _as_list, parse_prototxt, upgrade_net_prototxt

_LAYER_STYLE = ('shape=record, style="rounded,filled", '
                'fillcolor="#cde3b3"')
_DATA_STYLE = 'shape=record, style="rounded,filled", fillcolor="#fce6a8"'
_LOSS_STYLE = 'shape=record, style="rounded,filled", fillcolor="#f4b7b2"'
_BLOB_STYLE = 'shape=octagon, style=filled, fillcolor="#e0e0e0"'

_DATA_TYPES = {"Data", "HDF5Data", "ImageData", "MemoryData", "WindowData",
               "PairImageData", "Input", "DummyData"}


def _one(v, default=None):
    if isinstance(v, list):
        return v[-1] if v else default
    return default if v is None else v


def _phase_keeps(layer: dict, phase: str | None) -> bool:
    if phase is None:
        return True
    from ..models.graph_net import _phase_keeps as keeps  # imports torch

    return keeps(layer, phase)


def _layer_label(layer: dict) -> str:
    """Type + headline hyperparameters (draw.py get_layer_label's
    conv/pool annotations, generalized)."""
    t = str(layer.get("type", "?"))
    name = str(layer.get("name", "?"))
    bits = [name, t]
    if t in ("Convolution", "Deconvolution"):
        p = _one(layer.get("convolution_param"), {}) or {}
        k = (_one(p.get("kernel_size")) or
             f"{_one(p.get('kernel_h'), '?')}x{_one(p.get('kernel_w'), '?')}")
        bits.append(f"kernel {k} stride {_one(p.get('stride'), 1)} "
                    f"pad {_one(p.get('pad'), 0)} "
                    f"out {_one(p.get('num_output'), '?')}")
    elif t == "Pooling":
        p = _one(layer.get("pooling_param"), {}) or {}
        pool = str(_one(p.get("pool"), "MAX"))
        if str(_one(p.get("global_pooling"), False)).lower() == "true":
            bits.append(f"{pool} global")
        else:
            k = (_one(p.get("kernel_size")) or
                 f"{_one(p.get('kernel_h'), '?')}x"
                 f"{_one(p.get('kernel_w'), '?')}")
            bits.append(f"{pool} kernel {k} "
                        f"stride {_one(p.get('stride'), _one(p.get('stride_h'), 1))}")
    elif t == "InnerProduct":
        p = _one(layer.get("inner_product_param"), {}) or {}
        bits.append(f"out {_one(p.get('num_output'), '?')}")
    elif t == "Embed":
        p = _one(layer.get("embed_param"), {}) or {}
        bits.append(f"{_one(p.get('input_dim'), '?')} -> "
                    f"{_one(p.get('num_output'), '?')}")
    elif t == "SimCross":
        p = _one(layer.get("sim_cross_param"), {}) or {}
        bits.append(f"mode {_one(p.get('dist_mode'), 1)} "
                    f"M {_one(p.get('mesure_count'), 1)}")
    elif t == "Dropout":
        p = _one(layer.get("dropout_param"), {}) or {}
        bits.append(f"ratio {_one(p.get('dropout_ratio'), 0.5)}")
    elif t == "LRN":
        p = _one(layer.get("lrn_param"), {}) or {}
        bits.append(f"local {_one(p.get('local_size'), 5)}")
    def esc(t):
        for ch in "{}|<>":
            t = t.replace(ch, "\\" + ch)
        return t

    return "{" + "|".join(esc(str(b))
                          for b in bits) + "}"


def _q(s: str) -> str:
    return '"' + str(s).replace('"', r"\"") + '"'


def net_to_dot(prototxt_text: str, *, phase: str | None = None,
               rankdir: str = "LR", name: str | None = None) -> str:
    """NetParameter prototxt (any generation — auto-upgraded) -> DOT."""
    d = upgrade_net_prototxt(parse_prototxt(prototxt_text))
    net_name = name or str(_one(d.get("name"), "net"))
    lines = [f"digraph {_q(net_name)} {{",
             f"  rankdir={rankdir};"]
    blobs_seen: set = set()
    edges: list = []
    for layer in _as_list(d.get("layer")):
        if not isinstance(layer, dict) or not _phase_keeps(layer, phase):
            continue
        lname = str(layer.get("name", "?"))
        t = str(layer.get("type", "?"))
        bottoms = [str(b) for b in _as_list(layer.get("bottom"))]
        tops = [str(b) for b in _as_list(layer.get("top"))]
        style = (_DATA_STYLE if t in _DATA_TYPES
                 else _LOSS_STYLE if "Loss" in t
                 else _LAYER_STYLE)
        node = f"layer_{lname}"
        lines.append(f"  {_q(node)} [label={_q(_layer_label(layer))}, "
                     f"{style}];")
        for b in bottoms:
            blobs_seen.add(b)
            edges.append(f"  {_q('blob_' + b)} -> {_q(node)};")
        for tb in tops:
            blobs_seen.add(tb)
            if tb in bottoms:  # in-place: annotate instead of a cycle
                edges.append(f"  {_q(node)} -> {_q('blob_' + tb)} "
                             f"[style=dashed, label=\"in-place\"];")
            else:
                edges.append(f"  {_q(node)} -> {_q('blob_' + tb)};")
    for b in sorted(blobs_seen):
        lines.append(f"  {_q('blob_' + b)} [label={_q(b)}, {_BLOB_STYLE}];")
    lines.extend(edges)
    lines.append("}")
    return "\n".join(lines) + "\n"
