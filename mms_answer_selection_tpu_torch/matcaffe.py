"""matcaffe: the MATLAB binding surface as an RPC bridge (counterpart of
``matcaffe.py``).

The reference binds MATLAB through a MEX plugin
(matlab/+caffe/private/caffe_.cpp): one ``caffe_(command, ...)`` entry
point dispatching ~29 commands over registries of live Solver/Net/
Layer/Blob pointers, with a process-wide ``init_key`` invalidating
handles on reset (caffe_.cpp:44-47,131-147).  Here the compute path is
PyTorch on the card, not a C++ object graph, so the same surface is split
in two:

* :class:`MatBridge` (this module): the full command dispatch,
  implemented over the pycaffe-equivalent layer (``models.pynet`` /
  ``models.pysolver``).  In-process Python callers (and the tests) use
  it directly: ``caffe_('get_net', file, 'train')``.
* :func:`serve_matcaffe`: a tiny line-delimited-JSON TCP daemon
  exposing the dispatch, so the shipped ``matlab/+caffe`` package (a
  pure-``.m`` client, no MEX build) can drive a GPU host from any
  MATLAB/Octave session.  The daemon replaces the MEX boundary;
  the ``.m`` classes above it keep the reference's public API
  (Net/Blob/Layer/Solver/io, matlab/+caffe/Net.m etc.).

Data-layout contract (caffe_.cpp:7-10): matcaffe arrays are single
precision with dimensions REVERSED from caffe's — a caffe (num,
channels, height, width) blob is a matlab (width, height, channels,
num) array, width fastest.  Since this package's internal image layout
is NHWC (``models/graph_net.py``), 4-D blobs additionally permute NHWC
<-> NCHW at this boundary so MATLAB sees exactly the reference's axes.
Blobs live on the bridge's device; a read copies to the host.

Handles are ``{"ptr": int, "init_key": float}`` structs, validated
against the bridge's live ``init_key`` exactly like handle_to_ptr
(caffe_.cpp:131-147); ``reset`` clears the registries and rotates the
key so stale handles raise.
"""

from __future__ import annotations

import base64
import json
import socket
import socketserver
import threading

import numpy as np
import torch

from .device import resolve_device

__all__ = ["MatBridge", "caffe_", "serve_matcaffe", "default_bridge"]


# ---------------------------------------------------------------------------
# layout conversion (caffe_.cpp:55-110)
# ---------------------------------------------------------------------------

def _nhwc_to_caffe(a):
    """Internal activation -> caffe-axes view (4-D NHWC -> NCHW)."""
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _caffe_to_nhwc(a):
    a = np.asarray(a)
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def to_mat(a):
    """caffe-axes array -> matcaffe array: all dims reversed, single
    precision (blob_to_mx_mat, caffe_.cpp:79-110).  0-dim becomes
    (1,) like the mex's scalar special case."""
    a = np.asarray(a, np.float32)
    if a.ndim == 0:
        return a.reshape(1)
    return a.T  # reverses every axis; memory order matches matlab's


def from_mat(m, count=None):
    """matcaffe array -> caffe-axes float32 array (mx_mat_to_blob).
    ``count`` enforces the mex's element-count check."""
    m = np.asarray(m, np.float32)
    if count is not None and m.size != count:
        raise ValueError("number of elements in target blob doesn't "
                         "match that in input mxArray")
    return m.T


# ---------------------------------------------------------------------------
# blob adapters
# ---------------------------------------------------------------------------

def _caffe_shape(nhwc_shape):
    s = tuple(nhwc_shape)
    return (s[0], s[3], s[1], s[2]) if len(s) == 4 else s


class _ActBlob:
    """A named activation blob of a _MatNet: reads come from the last
    forward/backward (or the staged write), writes stage for the next
    forward.  Mirrors a live caffe::Blob closely enough for the
    matcaffe idioms (set_data -> forward_prefilled -> get_data).  The
    forward's value stays on the net's device; ``get_data`` copies this
    one blob to the host, and the shape checks read no data."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name

    def _shape(self):
        """The caffe-axes shape, None for a blob with no value yet (its
        first set_data defines it)."""
        s = self.owner._blob_shape(self.name)
        return None if s is None else _caffe_shape(s)

    def _shaped(self, caffe_arr):
        shape = self._shape()
        if shape is None:
            return caffe_arr
        if caffe_arr.size != int(np.prod(shape)):
            raise ValueError("number of elements in target blob doesn't "
                             "match that in input mxArray")
        return caffe_arr.reshape(shape)

    # caffe-axes (NCHW for 4-D) numpy views --------------------------------
    def get_data(self):
        a = self.owner._blob_value(self.name)
        return _nhwc_to_caffe(a)

    def set_data(self, caffe_arr):
        self.owner._stage_data(self.name,
                               _caffe_to_nhwc(self._shaped(caffe_arr)))

    def get_diff(self):
        a = self.owner._blob_diff(self.name)
        if a is None:
            return np.zeros(self.shape_caffe(), np.float32)
        return _nhwc_to_caffe(a)

    def set_diff(self, caffe_arr):
        self.owner._stage_diff(self.name,
                               _caffe_to_nhwc(self._shaped(caffe_arr)))

    def shape_caffe(self):
        shape = self._shape()
        if shape is None:
            self.owner._blob_value(self.name)   # raises: no value yet
        return shape

    def reshape(self, caffe_shape):
        shape = self._shape()
        n = int(np.prod(caffe_shape)) if len(caffe_shape) else 1
        if shape is not None and int(np.prod(shape)) == n:
            new = np.asarray(self.get_data(), np.float32).reshape(
                caffe_shape)
        else:
            new = np.zeros(caffe_shape, np.float32)
        self.owner._stage_data(self.name, _caffe_to_nhwc(new))


class _ParamBlob:
    """A layer's learned blob, in caffe layout (conv OIHW, fc (out,in) —
    graph_net.caffemodel_specs rows).  Writes map back through the
    spec's from_caffe into the live parameter tree."""

    def __init__(self, owner, layer_name, blob_idx):
        self.owner = owner
        self.layer_name, self.blob_idx = layer_name, blob_idx

    def _row(self):
        for layer, rows, _shared in self.owner._specs():
            if layer == self.layer_name:
                return rows[self.blob_idx]
        raise KeyError(self.layer_name)

    def get_data(self):
        _idx, tree, keypath, to_caffe, _from = self._row()
        node = self.owner._tree(tree)
        for k in keypath:
            node = node[k]
        return to_caffe(_host(node))

    def set_data(self, caffe_arr):
        _idx, tree, keypath, _to, from_caffe = self._row()
        cur = self.get_data()
        if caffe_arr.size != cur.size:
            raise ValueError("number of elements in target blob doesn't "
                             "match that in input mxArray")
        new = from_caffe(np.asarray(caffe_arr, np.float32)
                         .reshape(cur.shape))
        self.owner._write_tree(tree, keypath, torch.tensor(
            new, device=self.owner.device))

    def get_diff(self):
        g = self.owner._param_diff(self.layer_name, self.blob_idx)
        if g is None:
            return np.zeros_like(self.get_data())
        return g

    def set_diff(self, caffe_arr):
        raise ValueError("matcaffe: parameter diffs are produced by "
                         "net_backward; writing them is not supported")

    def shape_caffe(self):
        return self.get_data().shape

    def reshape(self, caffe_shape):
        raise ValueError("matcaffe: parameter blobs cannot be "
                         "reshaped (their shape is the layer's)")


# ---------------------------------------------------------------------------
# net adapter
# ---------------------------------------------------------------------------

class _MatNet:
    """matcaffe-facing adapter over a stand-alone ``models.pynet.Net``
    or a solver-owned ``models.pysolver._NetView``.

    Caffe's Net allocates every blob at construction (Net::Init runs a
    full Reshape pass), so matcaffe can read shapes before any forward.
    Here shapes come from tracing: construction runs ONE forward with
    zeros for declared inputs (deploy ``input_shape`` / Input layers)
    and the prototxt data feeds for the rest — after which every blob
    is materialized and the matcaffe idioms work unchanged."""

    def __init__(self, net_like, graph_net, *, device, is_view=False):
        self._n = net_like
        self._g = graph_net
        self.device = device
        self._is_view = is_view
        self._staged: dict[str, np.ndarray] = {}
        self._diffs: dict[str, np.ndarray] = {}
        # the last forward's blobs, where the net keeps them (the card)
        self._tensors: dict[str, torch.Tensor] = {}
        self._act_blobs: dict[str, _ActBlob] = {}
        self._param_blobs: dict[tuple, _ParamBlob] = {}
        self._init_forward()

    # -- graph metadata (net_get_attr) --------------------------------------
    def blob_names(self):
        """All net blobs in creation order: declared/external inputs
        first (Net::Init's AppendTop order), then each layer's new
        tops."""
        seen: dict[str, None] = {}
        for b in self.inputs():
            seen.setdefault(b, None)
        for node in self._g.layers:
            for t in node.tops:
                seen.setdefault(t, None)
        return list(seen)

    def layer_names(self):
        return [n.name for n in self._g.layers]

    def inputs(self):
        """matcaffe's net->input_blob_indices covers only NET INPUTS —
        net-level ``input:`` declarations, Input-layer tops, and
        unproduced bottoms (net.cpp AppendTop on net inputs).  Data-layer
        tops (DummyData/HDF5Data/...) are NOT inputs there (test_net.m
        asserts inputs == cell(0,1) on a DummyData net), even though
        set_data on them still feeds the next forward here."""
        declared = list(self._g.declared_input_shapes(nhwc=False))
        for n in self._g.layers:
            if n.type == "Input":
                for t in n.tops:
                    if t not in declared:
                        declared.append(t)
        produced = {t for n in self._g.layers for t in n.tops}
        wanted = {b for n in self._g.layers for b in n.bottoms}
        return declared + sorted(b for b in (wanted - produced)
                                 if b not in declared)

    def outputs(self):
        return self._g.output_blob_names()

    def layer_type(self, layer_name):
        for n in self._g.layers:
            if n.name == layer_name:
                return n.type
        raise KeyError(layer_name)

    # -- blob objects --------------------------------------------------------
    def act_blob(self, name):
        if name not in self._act_blobs:
            if name not in self.blob_names():
                raise KeyError(name)
            self._act_blobs[name] = _ActBlob(self, name)
        return self._act_blobs[name]

    def param_blob(self, layer_name, idx):
        key = (layer_name, idx)
        if key not in self._param_blobs:
            self._param_blobs[key] = _ParamBlob(self, layer_name, idx)
        return self._param_blobs[key]

    def layer_blob_count(self, layer_name):
        for layer, rows, _shared in self._specs():
            if layer == layer_name:
                return len(rows)
        return 0

    # -- the live trees ------------------------------------------------------
    def _specs(self):
        if self._is_view:
            p, s = self._n._trees()
            return self._g.caffemodel_specs(p, s)
        return self._g.caffemodel_specs(self._n.params, self._n.state)

    def _tree(self, which):
        if self._is_view:
            p, s = self._n._trees()
        else:
            p, s = self._n.params, self._n.state
        return p if which == "params" else s

    def _write_tree(self, which, keypath, value):
        if self._is_view and self._n._test_id is not None:
            raise ValueError(
                "test nets share the train net's weights "
                "(ShareTrainedLayersWith); write through the train net")
        tree = self._tree(which)
        node = tree
        for k in keypath[:-1]:
            node = node[k]
        node[keypath[-1]] = value
        if which == "params":
            # re-assign through the public setter so cached jits drop
            self._n.params = tree

    def _param_diff(self, layer_name, blob_idx):
        pd = getattr(self._n, "param_diffs", None)
        if not pd:
            return None
        for layer, rows, _shared in self._specs():
            if layer != layer_name:
                continue
            _idx, tree, keypath, to_caffe, _from = rows[blob_idx]
            if tree != "params":
                return None
            node = pd
            try:
                for k in keypath:
                    node = node[k]
            except (KeyError, TypeError):
                return None
            return to_caffe(_host(node))
        return None

    # -- blob value store ------------------------------------------------------
    def _blob_value(self, name):
        """The blob's value on the host: the staged write, else a copy of
        the last forward's tensor."""
        if name in self._staged:
            return self._staged[name]
        if name in self._tensors:
            return self._tensors[name].to(torch.float32).cpu().numpy()
        raise RuntimeError(
            f"blob '{name}' has no value yet: its shape could not be "
            "derived at construction (no input_shape declaration / data "
            "feed) — run forward with explicit inputs first")

    def _blob_shape(self, name):
        """The blob's NHWC shape, read without copying its data; None
        before it has a value."""
        if name in self._staged:
            return self._staged[name].shape
        if name in self._tensors:
            return tuple(self._tensors[name].shape)
        return None

    def _blob_diff(self, name):
        return self._diffs.get(name)

    def _stage_data(self, name, arr):
        self._staged[name] = np.asarray(arr, np.float32)

    def _stage_diff(self, name, arr):
        self._diffs[name] = np.asarray(arr, np.float32)

    # -- forward / backward ----------------------------------------------------
    def _init_forward(self):
        """Materialize every blob (Caffe allocates them in Net::Init).
        On a solver-owned train view the probe forward must not perturb
        training: BN running stats are restored afterwards (Net::Init
        allocates without running fillers' side effects either)."""
        feeds = {}
        declared = self._g.declared_input_shapes()
        for name, shape in declared.items():
            feeds[name] = torch.zeros(shape, dtype=torch.float32,
                                      device=self.device)
        gs = self._n._owner._gs if self._is_view else None
        saved_state = gs.state if gs is not None else None
        try:
            self.forward_prefilled(_init_feeds=feeds)
        except Exception:
            # nets whose inputs have no declared shapes stay lazy; the
            # first explicit forward materializes them
            self._tensors = {}
        finally:
            if gs is not None:
                gs.state = saved_state

    def forward_prefilled(self, *, _init_feeds=None):
        ins = dict(_init_feeds or {})
        for name, val in self._staged.items():
            ins[name] = torch.tensor(val, device=self.device)
        self._n.forward(**ins)
        # staged inputs stay staged (caffe's buffers persist) and win over
        # these in reads
        self._tensors.update({k: b.tensor.detach() for k, b in
                              self._n.blobs.items()})

    def backward_prefilled(self):
        if self._is_view:
            raise ValueError(
                "matcaffe: net_backward on a solver-owned net is not "
                "supported — the solver's step computes gradients; "
                "use a stand-alone Net for explicit backward")
        seeds = {}
        for name in self.outputs():
            d = self._diffs.get(name)
            if d is not None:
                seeds[name] = torch.as_tensor(d, device=self.device)
        if not seeds:
            # caffe's Backward seeds loss tops with their loss weight
            for name in self.outputs():
                v = self._tensors.get(name)
                if v is not None and v.ndim == 0:
                    seeds[name] = torch.ones((), device=self.device)
        if not seeds:
            raise ValueError("set an output diff (blob_set_diff) before "
                             "net_backward")
        gi = self._n.backward(**seeds)
        for k, v in gi.items():
            self._diffs[k] = np.asarray(v, np.float32)

    def copy_from(self, path):
        self._n.copy_from(path)

    def save(self, path):
        self._n.save(path)

    def reshape(self):
        # shapes re-derive from the staged arrays at the next forward;
        # nothing to do eagerly
        pass


# ---------------------------------------------------------------------------
# the bridge (== the mex's registries + dispatch)
# ---------------------------------------------------------------------------

class MatBridge:
    """The ``caffe_`` command surface (caffe_.cpp:528-560's handler
    table), over pynet/pysolver.  One instance == one mex load.

    Nets and solvers go to ``device`` (``None`` means CUDA); the client's
    ``set_mode_cpu`` / ``set_mode_gpu`` / ``set_device`` move the nets
    made after them, as Caffe::set_mode does (caffe_.cpp:432-450)."""

    def __init__(self, seed: int = 0, *, device=None):
        self._rng = np.random.default_rng(seed)
        self._objects: dict[int, object] = {}
        self._next = 1
        self.init_key = float(self._rng.integers(0, 2**31))
        dev = resolve_device(device)
        self.mode = "gpu" if dev.type == "cuda" else "cpu"
        self.device = dev.index or 0

    def _torch_device(self) -> torch.device:
        return resolve_device("cpu" if self.mode == "cpu"
                              else f"cuda:{self.device}")

    # -- handles (caffe_.cpp:131-184) ---------------------------------------
    def _register(self, obj) -> dict:
        ptr = self._next
        self._next += 1
        self._objects[ptr] = obj
        return {"ptr": ptr, "init_key": self.init_key}

    def _deref(self, handle, want=None):
        if not isinstance(handle, dict) or "ptr" not in handle:
            raise ValueError("handle must be a struct with ptr/init_key")
        if float(handle.get("init_key", -1)) != self.init_key:
            raise ValueError(
                "Could not convert handle to pointer due to invalid "
                "init_key. The object might have been cleared.")
        obj = self._objects.get(int(handle["ptr"]))
        if obj is None or (want is not None and not isinstance(obj, want)):
            raise ValueError("invalid handle")
        return obj

    # -- dispatch -------------------------------------------------------------
    def __call__(self, cmd, *args):
        fn = getattr(self, "cmd_" + cmd, None)
        if fn is None:
            raise ValueError(f"Unknown command '{cmd}'")
        return fn(*args)

    # -- solver commands -------------------------------------------------------
    def cmd_get_solver(self, solver_file):
        from .models.pysolver import get_solver
        solver = get_solver(solver_file, device=self._torch_device())
        return self._register(solver)

    def cmd_solver_get_attr(self, h):
        solver = self._deref(h)
        # idempotent: repeated attr queries must not re-run the
        # blob-materializing init forwards or mint duplicate adapters
        cached = getattr(solver, "_matcaffe_attr", None)
        if cached is not None:
            return cached
        gs = solver._gs
        net = _MatNet(solver.net, gs.net, device=gs.device, is_view=True)
        tests = [_MatNet(v, gs.test_nets[i], device=gs.device, is_view=True)
                 for i, v in enumerate(solver.test_nets)]
        attr = {"hNet_net": self._register(net),
                "hNet_test_nets": [self._register(t) for t in tests]}
        solver._matcaffe_attr = attr
        return attr

    def cmd_solver_get_iter(self, h):
        return float(self._deref(h).iter)

    def cmd_solver_restore(self, h, snapshot_file):
        self._deref(h).restore(snapshot_file)

    def cmd_solver_solve(self, h):
        self._deref(h).solve()

    def cmd_solver_step(self, h, iters):
        self._deref(h).step(int(iters))

    # -- net commands ------------------------------------------------------------
    def cmd_get_net(self, model_file, phase_name):
        from .models.pynet import Net
        if phase_name not in ("train", "test"):
            raise ValueError("Unknown phase")
        net = Net(model_file, phase=phase_name, device=self._torch_device())
        return self._register(_MatNet(net, net._net, device=net.device))

    def cmd_net_get_attr(self, h):
        mn = self._deref(h, _MatNet)
        cached = getattr(mn, "_attr_cache", None)
        if cached is not None:
            return cached
        blob_names = mn.blob_names()
        layer_names = mn.layer_names()
        blob_pos = {b: i for i, b in enumerate(blob_names)}
        layers = [self._register(("layer", mn, nm)) for nm in layer_names]
        blobs = [self._register(mn.act_blob(b)) for b in blob_names]
        attr = {
            "hLayer_layers": layers,
            "hBlob_blobs": blobs,
            "input_blob_indices": [blob_pos[b] for b in mn.inputs()
                                   if b in blob_pos],
            "output_blob_indices": [blob_pos[b] for b in mn.outputs()
                                    if b in blob_pos],
            "layer_names": layer_names,
            "blob_names": blob_names,
        }
        mn._attr_cache = attr
        return attr

    def cmd_net_forward(self, h):
        self._deref(h, _MatNet).forward_prefilled()

    def cmd_net_backward(self, h):
        self._deref(h, _MatNet).backward_prefilled()

    def cmd_net_copy_from(self, h, weights_file):
        self._deref(h, _MatNet).copy_from(weights_file)

    def cmd_net_reshape(self, h):
        self._deref(h, _MatNet).reshape()

    def cmd_net_save(self, h, save_file):
        self._deref(h, _MatNet).save(save_file)

    # -- layer commands -------------------------------------------------------------
    def cmd_layer_get_attr(self, h):
        kind, mn, name = self._deref(h)
        blobs = [self._register(mn.param_blob(name, i))
                 for i in range(mn.layer_blob_count(name))]
        return {"hBlob_blobs": blobs}

    def cmd_layer_get_type(self, h):
        kind, mn, name = self._deref(h)
        return mn.layer_type(name)

    # -- blob commands ---------------------------------------------------------------
    def _blob(self, h):
        obj = self._deref(h)
        if not isinstance(obj, (_ActBlob, _ParamBlob)):
            raise ValueError("invalid Blob handle")
        return obj

    def cmd_blob_get_shape(self, h):
        shape = self._blob(h).shape_caffe()
        # reversed, like blob_get_shape (caffe_.cpp:369-382)
        return [float(s) for s in reversed(shape)]

    def cmd_blob_reshape(self, h, mat_shape):
        # matlab shape vectors arrive as 1 x N row matrices — flatten
        flat = np.asarray(mat_shape).ravel()
        caffe_shape = tuple(int(s) for s in reversed(flat.tolist()))
        self._blob(h).reshape(caffe_shape)

    def cmd_blob_get_data(self, h):
        return to_mat(self._blob(h).get_data())

    def cmd_blob_set_data(self, h, mat):
        self._blob(h).set_data(from_mat(mat))

    def cmd_blob_get_diff(self, h):
        return to_mat(self._blob(h).get_diff())

    def cmd_blob_set_diff(self, h, mat):
        self._blob(h).set_diff(from_mat(mat))

    # -- global commands ---------------------------------------------------------------
    def cmd_set_mode_cpu(self):
        self.mode = "cpu"

    def cmd_set_mode_gpu(self):
        self.mode = "gpu"

    def cmd_set_device(self, device_id):
        self.device = int(device_id)

    def cmd_get_init_key(self):
        return self.init_key

    def cmd_reset(self):
        self._objects.clear()
        self.init_key = float(self._rng.integers(0, 2**31))

    def cmd_read_mean(self, mean_proto_file):
        from .utils.io import blobproto_to_array
        with open(mean_proto_file, "rb") as f:
            arr = blobproto_to_array(f.read())
        arr = np.asarray(arr, np.float32)
        m = to_mat(arr)
        # matlab drops trailing singleton dims (ndims >= 2)
        shape = list(m.shape)
        while len(shape) > 2 and shape[-1] == 1:
            shape.pop()
        return np.ascontiguousarray(m.reshape(shape))

    def cmd_write_mean(self, mat, mean_proto_file):
        from .utils.io import array_to_blobproto
        mat = np.asarray(mat, np.float32)
        if mat.ndim not in (2, 3):
            raise ValueError("mean_data must have at 2 or 3 dimensions")
        caffe = mat.T  # (C, H, W) or (H, W)
        if caffe.ndim == 2:
            caffe = caffe[None]
        with open(mean_proto_file, "wb") as f:
            f.write(array_to_blobproto(caffe[None]))  # (1, C, H, W)

    def cmd_version(self):
        from . import __version__
        return __version__


default_bridge = None


def caffe_(cmd, *args):
    """Module-level dispatch over a shared bridge (made on first use) —
    the in-process equivalent of the mex entry point
    (caffe_.cpp:562-584)."""
    global default_bridge
    if default_bridge is None:
        default_bridge = MatBridge()
    return default_bridge(cmd, *args)


# ---------------------------------------------------------------------------
# the wire protocol + daemon (replaces the MEX boundary)
# ---------------------------------------------------------------------------
#
# One JSON object per line.  Request: {"cmd": str, "args": [...]}.
# Response: {"ok": true, "out": value} | {"ok": false, "error": str}.
# Arrays travel as {"mat": 1, "shape": [...], "data": base64} with
# data = float32 little-endian in COLUMN-major (matlab-native) order.
# Handles and attr structs are plain JSON objects; strings/numbers map
# directly.  {"cmd": "ping"} answers {"ok": true, "out": "pong"};
# {"cmd": "shutdown"} stops the daemon.

def _host(t) -> np.ndarray:
    """A float32 host copy of a tensor or array."""
    if torch.is_tensor(t):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def encode_value(v):
    if isinstance(v, np.ndarray):
        return {"mat": 1, "shape": list(v.shape),
                "data": base64.b64encode(
                    np.asfortranarray(v, np.float32).tobytes(
                        order="F")).decode()}
    if isinstance(v, dict):
        return {k: encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        return float(v)
    return v


def decode_value(v):
    if isinstance(v, dict) and v.get("mat"):
        raw = base64.b64decode(v["data"])
        shape = tuple(int(s) for s in v["shape"])
        return np.frombuffer(raw, "<f4").reshape(shape, order="F")
    if isinstance(v, dict):
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        bridge = self.server.bridge
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                cmd = req["cmd"]
                if cmd == "ping":
                    resp = {"ok": True, "out": "pong"}
                elif cmd == "shutdown":
                    resp = {"ok": True, "out": "bye"}
                    self._send(resp)
                    self.server._stop.set()
                    return
                else:
                    args = [decode_value(a) for a in req.get("args", [])]
                    out = bridge(cmd, *args)
                    resp = {"ok": True, "out": encode_value(out)}
            except Exception as e:  # noqa: BLE001 - mirrors mexErrMsgTxt
                resp = {"ok": False, "error": str(e)}
            self._send(resp)

    def _send(self, resp):
        self.wfile.write((json.dumps(resp) + "\n").encode())
        self.wfile.flush()


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve_matcaffe(host: str = "127.0.0.1", port: int = 0,
                   bridge: MatBridge | None = None, *,
                   background: bool = False):
    """Run the matcaffe bridge daemon.  Returns (server, bound_port);
    with background=True it serves from a daemon thread (tests), else
    blocks until a client sends {"cmd": "shutdown"}."""
    srv = _Server((host, port), _Handler)
    srv.bridge = bridge if bridge is not None else MatBridge()
    srv._stop = threading.Event()
    bound = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    if background:
        return srv, bound
    try:
        srv._stop.wait()
    except KeyboardInterrupt:
        pass
    srv.shutdown()
    return srv, bound


class MatClient:
    """Python twin of the ``.m`` client (matlab/+caffe/private/caffe_.m):
    speaks the exact wire protocol, so the daemon's MATLAB-facing
    behavior is testable without MATLAB."""

    def __init__(self, host="127.0.0.1", port=0):
        self._sock = socket.create_connection((host, port))
        self._f = self._sock.makefile("rwb")

    def __call__(self, cmd, *args):
        req = {"cmd": cmd, "args": [encode_value(a) for a in args]}
        self._f.write((json.dumps(req) + "\n").encode())
        self._f.flush()
        resp = json.loads(self._f.readline())
        if not resp["ok"]:
            raise RuntimeError(resp["error"])
        return decode_value(resp.get("out"))

    def close(self):
        self._f.close()
        self._sock.close()
