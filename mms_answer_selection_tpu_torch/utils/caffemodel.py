"""Reference-format weight interop (counterpart of ``utils/caffemodel.py``):
`.caffemodel` / `.caffemodel.h5` / `.solverstate` <-> our param trees.

The trees are nested dicts of tensors (or arrays); writers copy them to
the host as float32 numpy and emit the bytes the JAX package emits for the
same values; readers return copies of the trees whose loaded leaves are
tensors on each destination leaf's device, in its dtype.

The reference snapshots model weights either as NetParameter binaryproto
or as HDF5 (`Net::ToHDF5`, net.cpp:859-913) with layout

    /data/<layer_name>/<param_index>   float datasets (+ optional /diff)

and restores them BY LAYER NAME with shape checks, ignoring unknown
layers (`CopyTrainedLayersFromHDF5`, net.cpp:797-844) -- that name-based
contract is what makes `caffe train -weights` finetuning work.  This
module speaks that HDF5 dialect for the MMS QA nets, so weights trained
in the reference can be loaded here (and vice versa) without conversion
scripts.

Layer names follow the QA script's NetSpec (do_trec_qa_clean.py:452-498):
``w2v_q`` (Embed; ``w2v_a`` shares its params, so its group is saved
empty -- "only save params that own themselves"), ``sim_cross`` (blob 0
= (M, D, D) metric, blob 1 = (M, W1, W2) bias, sim_cross_layer.cpp:
24-45), ``conv<i>`` (OIHW -> our HWIO), ``bn<i>`` (4 blobs: scale,
shift, running mean, running var as (1, C, 1, 1), bn_layer.cpp:91-117 --
the stat blobs land in OUR ``state``, not params), ``fc<i>`` ((out, in)
-> our (in, out)).
"""

from __future__ import annotations

import numpy as np
import torch


_t = lambda *axes: (lambda a: np.transpose(a, axes))  # noqa: E731
_ident = lambda a: a  # noqa: E731


def _embed_rows(params, key):
    """Embed layer rows: weight (V, D); bias 1-D (N,) per the reference
    EmbedLayer (embed_layer.cpp: vector<int> bias_shape(1, N_)) -- export
    the identity shape (Blob::ShapeEquals compares dims exactly, a (1, N)
    export would LOG(FATAL) on load); import stays reshape-tolerant for
    files written with the old convention."""
    rows = [(0, "params", (key, "w"), _ident, _ident)]
    if "b" in params[key]:
        d = params[key]["b"].shape[0]
        rows.append((1, "params", (key, "b"), _ident,
                     lambda a: np.reshape(a, (d,))))
    return rows


def _sim_rows(params):
    rows = [(0, "params", ("sim", "w"), _ident, _ident)]
    if "b" in params["sim"]:
        rows.append((1, "params", ("sim", "b"), _ident, _ident))
    return rows


def _conv_bn_specs(params):
    """conv{i} (our HWIO <-> caffe OIHW) + the custom BN layer's 4 blobs
    (learned scale/shift + running stats as (1, C, 1, 1),
    bn_layer.cpp:91-117; the stats live in OUR ``state``)."""
    specs = []
    i = 0
    while f"conv{i}" in params:
        specs.append((f"conv{i}", [
            (0, "params", (f"conv{i}", "w"), _t(3, 2, 0, 1), _t(2, 3, 1, 0)),
            (1, "params", (f"conv{i}", "b"), _ident, _ident),
        ], False))
        if f"bn{i}" in params:
            c = params[f"bn{i}"]["scale"].shape[0]
            wide = lambda a, c=c: np.reshape(a, (1, c, 1, 1))  # noqa: E731
            flat = lambda a, c=c: np.reshape(a, (c,))  # noqa: E731
            specs.append((f"bn{i}", [
                (0, "params", (f"bn{i}", "scale"), wide, flat),
                (1, "params", (f"bn{i}", "shift"), wide, flat),
                (2, "state", (f"bn{i}", "mean"), wide, flat),
                (3, "state", (f"bn{i}", "var"), wide, flat),
            ], False))
        i += 1
    return specs


def _ip_spec(params, key, layer_name=None):
    """InnerProduct-style rows: our (in, out) <-> caffe (out, in)."""
    return (layer_name or key, [
        (0, "params", (key, "w"), _t(1, 0), _t(1, 0)),
        (1, "params", (key, "b"), _ident, _ident),
    ], False)


def _specs_mms_qa(params, state):
    """The QA nets' NetSpec names (do_trec_qa_clean.py:452-498)."""
    specs = []
    rows = _embed_rows(params, "embed")
    specs.append(("w2v_q", rows, False))
    specs.append(("w2v_a", rows, True))  # shares w2v_q's params
    if "sim" in params:
        specs.append(("sim_cross", _sim_rows(params), False))
    specs += _conv_bn_specs(params)
    for name in ("fc1", "fc2"):
        if name in params:
            specs.append(_ip_spec(params, name))
    return specs


def _specs_pair_image(params, state):
    """Siamese image-pair net (models/pair_image.py): shared conv encoder
    + fc + scalar score head.  The reference assembles this from generic
    layers (SURVEY §2.1 PairImageData row); layer names here are the
    canonical ones our prototxt exporter writes."""
    specs = _conv_bn_specs(params)
    specs.append(_ip_spec(params, "fc"))
    specs.append(_ip_spec(params, "score"))
    return specs


def _specs_caption_image(params, state):
    """Cross-modal caption->image net (models/caption_image.py): text
    embed + conv patch encoder + proj into the shared token space + the
    learned bilinear metric."""
    specs = [("w2v", _embed_rows(params, "embed"), False)]
    specs += _conv_bn_specs(params)
    specs.append(_ip_spec(params, "proj"))
    specs.append(("sim_cross", _sim_rows(params), False))
    return specs


# model-family registry: (name, detector over the params tree, specs
# function).  Detection order matters -- the QA head (fc1+fc2) is checked
# first, then the cross-modal signature (proj+sim), then the siamese pair
# head (fc+score).  register_model_family() extends this for new models.
_FAMILIES = [
    ("mms_qa", lambda p: "embed" in p and "fc1" in p, _specs_mms_qa),
    ("caption_image", lambda p: "proj" in p and "sim" in p,
     _specs_caption_image),
    ("pair_image", lambda p: "score" in p and "fc" in p, _specs_pair_image),
]


def register_model_family(name, detector, spec_builder, *, front=True):
    """Extension point: register (detector(params) -> bool,
    spec_builder(params, state) -> specs) for a new model family so its
    nets round-trip the reference formats like the built-ins."""
    _FAMILIES.insert(0 if front else len(_FAMILIES),
                     (name, detector, spec_builder))


def detect_family(params) -> str:
    for name, detect, _ in _FAMILIES:
        if detect(params):
            return name
    raise ValueError(
        f"cannot map params with top-level keys {sorted(params)} onto a "
        "known model family (mms_qa / caption_image / pair_image); "
        "register one with caffemodel.register_model_family")


def _layer_specs(params, state):
    """Yields (layer_name, rows, shared) for every reference layer present
    in the trees; rows = [(param_index, tree, key_path, to_caffe,
    from_caffe), ...], ``tree`` is 'params' or 'state'.  ``shared`` marks
    a layer whose params are OWNED elsewhere (w2v_a shares w2v_q's): the
    HDF5 writer emits it as an empty group (ToHDF5 only saves owners,
    net.cpp:889-897) while the binaryproto writer duplicates the shared
    blobs (Net::ToProto serializes every layer's blob list, data-shared,
    net.cpp:847-856) -- and the loaders accept both conventions.

    Dispatches on the detected model family (Net::ToProto serializes ANY
    net, net.cpp:847-913 -- so must we)."""
    for name, detect, build in _FAMILIES:
        if detect(params):
            return build(params, state)
    return detect_family(params)  # raises with the explanatory message


def _host(tree):
    """A tree's leaves as host numpy arrays (the writers' input)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _copy(tree):
    """New dicts over the same leaves (the readers' output trees)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


def _like(src, dst):
    """``src`` (numpy) as a leaf like ``dst``: a contiguous tensor on its
    device in its dtype, or a numpy array of its dtype."""
    if isinstance(dst, torch.Tensor):
        return torch.as_tensor(np.ascontiguousarray(src), dtype=dst.dtype,
                               device=dst.device)
    return np.asarray(src, np.asarray(dst).dtype)


def _get(trees, tree, path):
    node = trees[tree]
    for k in path:
        node = node[k]
    return node


def _set(trees, tree, path, value):
    node = trees[tree]
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def save_caffemodel_h5(path, params, state, *, specs=None):
    """Write weights in the reference's Net::ToHDF5 layout."""
    import h5py

    params, state = _host(params), _host(state)
    trees = {"params": params, "state": state}
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for layer, rows, shared in (specs if specs is not None
                                    else _layer_specs(params, state)):
            g = data.create_group(layer)
            if shared:  # ToHDF5 only saves params that own themselves
                continue
            for idx, tree, keypath, to_caffe, _ in rows:
                arr = np.asarray(_get(trees, tree, keypath), np.float32)
                g.create_dataset(str(idx), data=to_caffe(arr))
    return path


def load_caffemodel_h5(path, params, state, *, specs=None):
    """Name-based, shape-checked weight loading from a reference-layout
    HDF5 file into copies of (params, state).  Reference semantics
    (net.cpp:797-844): source layers our net doesn't have are ignored;
    a missing dataset for a shared-param layer is fine; a shape mismatch
    is an error.  Returns (params, state, report dict)."""
    import h5py

    params, state = _copy(params), _copy(state)
    trees = {"params": params, "state": state}
    known = {name: (rows, shared) for name, rows, shared in
             (specs if specs is not None else _layer_specs(params, state))}
    report: dict = {}
    with h5py.File(path, "r") as f:
        data = f["data"]
        for layer in data:
            if layer not in known:
                report[layer] = "ignored (no such layer here)"
                continue
            g = data[layer]
            rows, shared = known[layer]
            if len(g) > len(rows):
                # net.cpp:819-821 CHECK_LE: a source layer with MORE
                # blobs than ours is a different architecture
                raise ValueError(
                    f"layer {layer}: file has {len(g)} datasets, model "
                    f"expects {len(rows)} (net.cpp:819 CHECK_LEs the "
                    f"same)")
            for idx, tree, keypath, _, from_caffe in rows:
                if str(idx) not in g:
                    if not shared:
                        # an OWNED param with no dataset is the
                        # truncated-file case net.cpp:797-844 LOG(FATAL)s
                        # on; only shared-param layers legitimately omit
                        raise ValueError(
                            f"layer {layer!r} owns param blob {idx} but "
                            f"{path} has no dataset for it "
                            f"(net.cpp:822 CHECKs the same)")
                    report[f"{layer}/{idx}"] = "absent (shared param)"
                    continue
                src = from_caffe(np.asarray(g[str(idx)]))
                dst = _get(trees, tree, keypath)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"shape mismatch for {layer}/{idx}: file "
                        f"{src.shape} vs model {tuple(dst.shape)} "
                        "(net.cpp would CHECK-fail here too)")
                _set(trees, tree, keypath, _like(src, dst))
                report[f"{layer}/{idx}"] = "loaded"
    return params, state, report


def load_caffemodel_auto(path, params, state, *, specs=None):
    """Dispatch h5-vs-binaryproto by the 4-byte HDF5 magic — files get
    renamed/copied, so content beats suffix (Net::CopyTrainedLayers'
    own dispatch is by extension, but its h5 reader fails loudly;
    feeding HDF5 bytes to a wire parser fails confusingly)."""
    with open(path, "rb") as f:
        is_h5 = f.read(4) == b"\x89HDF"
    loader = load_caffemodel_h5 if is_h5 else load_caffemodel_binaryproto
    return loader(path, params, state, specs=specs)


# ---------------------------------------------------------------------------
# binaryproto `.caffemodel` (the reference's DEFAULT snapshot format:
# SolverParameter.snapshot_format default BINARYPROTO, caffe.proto:198).
#
# A NetParameter binaryproto is, for weight-loading purposes, just:
#   NetParameter { repeated LayerParameter layer = 100; }   (caffe.proto:92)
#   LayerParameter { string name = 1; string type = 2;
#                    repeated BlobProto blobs = 7; }        (:311-329)
#   BlobProto { BlobShape shape = 7; repeated float data = 5 [packed];
#               repeated double double_data = 8 [packed];
#               int32 num/channels/height/width = 1..4 (legacy 4D) } (:10-21)
#   BlobShape { repeated int64 dim = 1 [packed]; }          (:7)
# The loader below is a minimal protobuf wire-format reader for exactly
# that subset (varints + length-delimited groups + packed scalars),
# written clean-room from the wire spec -- no generated code, no schema
# copy.  Unknown fields are skipped, so full solver-written files parse.
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf):
    """Yields (field_number, wire_type, value) over one message's bytes.
    value: int for varint(0)/fixed(1,5), memoryview for length-delim(2)."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_blob(buf):
    """BlobProto bytes -> float32 ndarray with its declared shape."""
    shape = None
    legacy = [0, 0, 0, 0]
    data = []
    for field, wt, val in _iter_fields(buf):
        if field == 7 and wt == 2:  # shape: BlobShape{dim=1 packed varint}
            dims = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:  # packed
                    p = 0
                    while p < len(v2):
                        d, p = _read_varint(v2, p)
                        dims.append(d)
                elif f2 == 1 and w2 == 0:  # unpacked varint dim
                    dims.append(v2)
            shape = tuple(dims)
        elif field == 5 and wt in (2, 5):  # float data, packed or not
            data.append(np.frombuffer(bytes(val), "<f4"))
        elif field == 8 and wt == 2:  # double data
            data.append(np.frombuffer(bytes(val), "<f8").astype(np.float32))
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy 4D dims
            legacy[field - 1] = val
    arr = np.concatenate(data) if data else np.zeros(0, np.float32)
    if shape is None:
        shape = tuple(d for d in legacy)
    if int(np.prod(shape)) != arr.size:
        raise ValueError(f"blob shape {shape} != data size {arr.size}")
    return arr.reshape(shape).astype(np.float32)


def _parse_layers(buf):
    """NetParameter bytes -> [(layer_name, [blob arrays...]), ...].
    Reads modern ``layer`` (field 100: name=1, blobs=7) AND legacy V1
    ``layers`` (field 2: name=4, blobs=6, nested V0 layer=1 with
    name=1/blobs=50) — ReadNetParamsFromBinaryFileOrDie upgrades
    transparently before CopyTrainedLayersFrom, so a pre-upgrade
    .caffemodel must load its weights here too, not silently no-op."""
    layers = []
    for field, wt, val in _iter_fields(buf):
        if field == 100 and wt == 2:  # modern LayerParameter
            name = ""
            blobs = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_parse_blob(v2))
            layers.append((name, blobs))
        elif field == 2 and wt == 2:  # V1LayerParameter
            name = ""
            blobs = []
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 4 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 6 and w2 == 2:
                    blobs.append(_parse_blob(v2))
                elif f2 == 1 and w2 == 2:  # nested V0LayerParameter
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            name = bytes(v3).decode("utf-8", "replace")
                        elif f3 == 50 and w3 == 2:
                            blobs.append(_parse_blob(v3))
            layers.append((name, blobs))
    return layers


def _varint(n):
    out = bytearray()
    # negative int32/int64 fields encode as 10-byte sign-extended
    # varints; without the mask the shift loop never terminates
    n = int(n) & ((1 << 64) - 1)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num, wt, payload):
    if wt == 2:
        return _varint((num << 3) | 2) + _varint(len(payload)) + payload
    if wt == 0:
        return _varint(num << 3) + _varint(payload)
    raise ValueError(wt)


def _emit_blob(arr):
    shape = b"".join(_varint(int(d)) for d in arr.shape)
    blob = _field(7, 2, _field(1, 2, shape))          # shape.dim packed
    blob += _field(5, 2, np.asarray(arr, "<f4").tobytes())  # data packed
    return blob


def save_caffemodel_binaryproto(path, params, state, *, specs=None):
    """Write a NetParameter binaryproto `.caffemodel` the reference's
    CopyTrainedLayersFromBinaryProto (net.cpp:789-795) can restore."""
    params, state = _host(params), _host(state)
    trees = {"params": params, "state": state}
    out = bytearray()
    for layer, rows, _shared in (specs if specs is not None
                                 else _layer_specs(params, state)):
        body = _field(1, 2, layer.encode())
        # unlike ToHDF5, Net::ToProto serializes EVERY layer's blob list,
        # so shared layers carry duplicated (data-shared) blobs too
        # (net.cpp:847-856) -- CopyTrainedLayersFrom CHECK_EQs the count
        for idx, tree, keypath, to_caffe, _ in rows:
            arr = to_caffe(np.asarray(_get(trees, tree, keypath),
                                      np.float32))
            body += _field(7, 2, _emit_blob(arr))
        out += _field(100, 2, bytes(body))
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def save_blob_binaryproto(path, arr, *, legacy_dims: bool = True):
    """Write ONE BlobProto to a file — the tools' mean-file format.
    ``compute_image_mean`` serializes the mean with the LEGACY
    num/channels/height/width dim fields (compute_image_mean.cpp:58-61),
    not a BlobShape, so that is the default here; arrays of rank < 4 are
    left-padded with 1s the way the tool's (1, C, H, W) output is."""
    arr = np.asarray(arr, np.float32)
    if legacy_dims:
        if arr.ndim > 4:
            raise ValueError(f"legacy blob dims are 4-D max, got "
                             f"{arr.shape}")
        dims = (1,) * (4 - arr.ndim) + arr.shape
        out = b"".join(_field(i + 1, 0, int(d))
                       for i, d in enumerate(dims))
        out += _field(5, 2, np.ascontiguousarray(arr, "<f4").tobytes())
    else:
        out = _emit_blob(arr)
    with open(path, "wb") as f:
        f.write(out)
    return path


def load_blob_binaryproto(path):
    """Read ONE BlobProto file (modern BlobShape or legacy 4-D dims) ->
    float32 ndarray — the `mean_file` consumer
    (data_transformer.cpp:29-48 ReadProtoFromBinaryFileOrDie path)."""
    with open(path, "rb") as f:
        return _parse_blob(f.read())


def load_caffemodel_binaryproto(path, params, state, *, specs=None):
    """Name-based, shape-checked load from a NetParameter binaryproto
    (the `caffe train -weights x.caffemodel` path, net.cpp:741-777
    semantics).  Returns (params, state, report)."""
    params, state = _copy(params), _copy(state)
    trees = {"params": params, "state": state}
    known = {name: rows for name, rows, _ in
             (specs if specs is not None else _layer_specs(params, state))}
    report: dict = {}
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    for layer, blobs in _parse_layers(buf):
        if layer not in known:
            report[layer] = "ignored (no such layer here)"
            continue
        rows = known[layer]
        if len(blobs) != len(rows):
            # CopyTrainedLayersFrom CHECK_EQs the blob count (net.cpp:755):
            # a bias-less source conv must hard-fail, not silently leave
            # init values in the unfilled rows
            raise ValueError(
                f"layer {layer}: file has {len(blobs)} blobs, model "
                f"expects {len(rows)} (net.cpp:755 CHECK_EQs the same)")
        for (idx, tree, keypath, to_caffe, from_caffe), arr in zip(rows,
                                                                   blobs):
            dst = _get(trees, tree, keypath)
            want = np.shape(to_caffe(np.zeros(tuple(dst.shape), np.float32)))
            if tuple(arr.shape) != want and arr.ndim == 4 \
                    and len(want) <= 4 \
                    and arr.shape == (1,) * (4 - len(want)) + want:
                # legacy 4-D (num, channels, h, w) dims right-align onto
                # the modern shape (blob.cpp ShapeEquals' legacy branch:
                # V0-era blobs store 2-D weights as (1, 1, out, in))
                arr = arr.reshape(want)
            src = from_caffe(arr)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch for {layer} blob {idx}: file "
                    f"{src.shape} vs model {tuple(dst.shape)}")
            _set(trees, tree, keypath, _like(src, dst))
            report[f"{layer}/{idx}"] = "loaded"
    return params, state, report


# ---------------------------------------------------------------------------
# `.solverstate` interop: resume a REFERENCE training run here (and export
# ours back).  SolverState (caffe.proto:245-250): iter=1, learned_net=2,
# history (repeated BlobProto)=3, current_step=4.  The history blobs are
# ordered by the net's learnable params (layer order, owned params only,
# net.cpp AppendParam), one pass per accumulator: SGD-family solvers store
# n blobs; AdaDelta/Adam append a second n (grad^2/m first, then
# update^2/v -- adadelta_solver.cpp:8-17, sgd_solver.cpp:305-322).  BN's
# running-stat blobs are lr_mult-0 learnable params in the reference, so
# they occupy history slots; their accumulators are meaningless and are
# skipped on import / zero-filled on export.
# ---------------------------------------------------------------------------


def _solver_rows(params, state, specs=None):
    """(is_param, tree, keypath, to_caffe, from_caffe) in the reference
    net's learnable-param order (OWNED params only -- shared layers do
    not add learnable_params entries, net.cpp AppendParam)."""
    rows = []
    for _, layer_rows, shared in (specs if specs is not None
                                  else _layer_specs(params, state)):
        if shared:
            continue
        for idx, tree, keypath, to_c, from_c in layer_rows:
            rows.append((tree == "params", tree, keypath, to_c, from_c))
    return rows


def save_solverstate_binaryproto(path, params, state, opt_state, it, *,
                                 current_step=0, learned_net="",
                                 specs=None):
    """Write a reference-restorable SolverState binaryproto."""
    params, state, opt_state = _host(params), _host(state), _host(opt_state)
    out = bytearray()
    out += _field(1, 0, int(it))
    if learned_net:
        out += _field(2, 2, learned_net.encode())
    for arr in _solver_history_arrays(params, state, opt_state,
                                      specs):
        out += _field(3, 2, _emit_blob(arr))
    out += _field(4, 0, int(current_step))
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


def _solver_history_arrays(params, state, opt_state, specs=None):
    """Yields the ordered history blobs both solverstate exporters write:
    per accumulator ('h' then 'h2' when present), one caffe-layout array
    per learnable-param row, with BN stat slots zero-filled (their
    lr_mult is 0 -- dead weight either way)."""
    trees = {"params": params, "state": state}
    rows = _solver_rows(params, state, specs)
    for acc in ("h", "h2"):
        if acc not in opt_state:
            continue
        for is_param, tree, keypath, to_c, _ in rows:
            if is_param:
                yield to_c(np.asarray(
                    _get({"params": opt_state[acc]}, "params", keypath),
                    np.float32))
            else:
                yield to_c(np.zeros_like(np.asarray(
                    _get(trees, tree, keypath), np.float32)))


def save_solverstate_h5(path, params, state, opt_state, it, *,
                        current_step=0, learned_net="", specs=None):
    """The HDF5 solverstate variant (SnapshotSolverStateToHDF5,
    sgd_solver.cpp:279-302): int datasets `iter`/`current_step`, a
    `learned_net` STRING dataset in the H5LTmake_dataset_string
    convention (scalar fixed-length string of strlen+1 incl. the NUL
    terminator -- hdf5_load_string allocates by the TYPE size, so a
    uint8-array dataset would make it under-allocate), and a `history`
    group of 0..k-1 datasets in learnable-param order."""
    import h5py

    params, state, opt_state = _host(params), _host(state), _host(opt_state)
    with h5py.File(path, "w") as f:
        f.create_dataset("iter", data=np.int64(it))
        f.create_dataset("current_step", data=np.int64(current_step))
        if learned_net:
            dt = h5py.string_dtype(encoding="ascii",
                                   length=len(learned_net) + 1)
            f.create_dataset("learned_net", data=learned_net.encode(),
                             dtype=dt)
        hist = f.create_group("history")
        for i, arr in enumerate(
                _solver_history_arrays(params, state, opt_state, specs)):
            hist.create_dataset(str(i), data=arr)
    return path


def load_solverstate(path, params, state, opt_state, *, specs=None):
    """Restore solver history + iteration from a reference `.solverstate`
    (binaryproto or the HDF5 variant, dispatched on the file magic) into a
    copy of ``opt_state``.  Returns (opt_state, iter, current_step,
    learned_net, report).  The reference CHECKs history length == its
    blob count (sgd_solver.cpp:316); we do the same modulo solver family
    (n blobs = single-accumulator family, 2n = AdaDelta/Adam)."""
    opt_state = _copy(opt_state)
    rows = _solver_rows(params, state, specs)
    n = len(rows)

    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"\x89HDF":
        import h5py
        with h5py.File(path, "r") as f:
            it = int(np.asarray(f["iter"]))
            cur = int(np.asarray(f["current_step"])) \
                if "current_step" in f else 0
            # hdf5_save_string stores strlen+1 incl. the NUL terminator
            # (util/hdf5.cpp); strip it or the path never resolves
            learned = (bytes(np.asarray(f["learned_net"]))
                       .decode("utf-8", "replace").rstrip("\x00")
                       if "learned_net" in f else "")
            hist = [np.asarray(f["history"][str(i)], np.float32)
                    for i in range(len(f["history"]))]
    else:
        with open(path, "rb") as f:
            buf = memoryview(f.read())
        it, cur, learned = 0, 0, ""
        hist = []
        for field, wt, val in _iter_fields(buf):
            if field == 1 and wt == 0:
                it = val
            elif field == 2 and wt == 2:
                learned = bytes(val).decode("utf-8", "replace")
            elif field == 3 and wt == 2:
                hist.append(_parse_blob(val))
            elif field == 4 and wt == 0:
                cur = val

    accs = [a for a in ("h", "h2") if a in opt_state]
    if len(hist) != n * len(accs):
        raise ValueError(
            f"history length {len(hist)} != {n} params x {len(accs)} "
            f"accumulators -- solver family mismatch "
            f"(sgd_solver.cpp:316 CHECKs the same)")
    report: dict = {}
    for a_i, acc in enumerate(accs):
        for r_i, (is_param, tree, keypath, _, from_c) in enumerate(rows):
            blob = hist[a_i * n + r_i]
            name = f"{acc}/{'/'.join(keypath)}"
            if not is_param:
                report[name] = "skipped (BN stat slot)"
                continue
            src = from_c(blob)
            dst = _get({"params": opt_state[acc]}, "params", keypath)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch for history {name}: "
                                 f"{src.shape} vs {tuple(dst.shape)}")
            _set({"params": opt_state[acc]}, "params", keypath,
                 _like(src, dst))
            report[name] = "loaded"
    return opt_state, int(it), int(cur), learned, report
