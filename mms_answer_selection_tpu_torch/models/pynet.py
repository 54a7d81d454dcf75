"""pycaffe-style stateful ``Net`` (counterpart of ``models/pynet.py``).

The reference's Python users hold a ``caffe.Net`` with mutable blob
state: ``net.blobs['ip'].data``, ``net.params['conv'][0].data``,
``net.forward(data=x)``, ``net.backward(loss=g)``
(python/caffe/pycaffe.py:22-233, _caffe.cpp:142-345).  This wrapper gives
that working style over `GraphNet`: ``Net`` keeps (params, state, last
blobs) as attributes and re-exposes them the pycaffe way.

* The net runs eagerly on one device: ``device=`` if given, else the one
  ``caffe_compat.set_mode_*`` chose, else CUDA (which raises without a
  card).  A forward builds no autograd graph; ``backward`` replays the
  last forward under autograd with the same random draws.
* Random layers (Dropout, ...) draw from a ``torch.Generator`` on the
  device, seeded from (seed, call number) as ``GraphSolver`` seeds a step.
  Parameters are drawn by a CPU generator, so a seed gives the same
  weights on either device.
* A blob holds its tensor where the net ran; ``.data`` copies it to the
  host only when read.  ``forward`` returns the output blobs themselves
  (array-like: ``float()``, ``np.asarray``, indexing, numpy methods and
  arithmetic read the host copy).

Differences from the reference, as in the JAX package:

* Blob shapes come from the first ``forward``; pretrained weights load
  lazily at the first forward.
* ``net.params[layer]`` is a dict keyed by blob name ("w"/"b"/...), not a
  positional list; ``net.param_diffs`` (filled by ``backward``) mirrors it.
* ``backward`` returns diffs for FLOAT input blobs only; those blobs also
  carry them as ``.diff``.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict

import numpy as np
import torch

from ..device import pycaffe_device
from ..training.trainer import derive_seed
from ..utils.tree import tree_leaves, tree_map
from .graph_net import DATA_TYPES, GraphNet

__all__ = ["Net", "Blob"]

# seed-derivation tags of the init and forward generators
_INIT, _FWD = 0xD0, 0xF0


_NO_DIFF = ("this blob has no diff: net.backward(...) fills the diffs of "
            "the float input blobs it differentiates (and net.param_diffs)")


def _as_tensor(v, device):
    if isinstance(v, Blob):
        v = v._current()
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        v = torch.as_tensor(a if a.flags.writeable else a.copy())
    return v.to(device)


class Blob(np.lib.mixins.NDArrayOperatorsMixin):
    """pycaffe blob view: ``net.blobs['ip'].data`` reads the array
    (_caffe.cpp:142-179 exposes zero-copy numpy views).  The value lives
    on the device, so ``.data`` hands out a WRITABLE host copy, made at the
    first read: in-place writes (``net.blobs['data'].data[...] = x``) are
    detected and fed into the next ``forward()`` (pycaffe.py:97-104), and
    partial forwards and backwards seed from the written value too.  Also
    array-like (``np.asarray``, ``float()``, indexing, arithmetic), so code
    that forgot ``.data`` works too."""

    __slots__ = ("_a", "_buf", "_digest", "_g", "_gbuf")

    def __init__(self, a):
        self._a = a
        self._buf = None
        self._digest = None
        self._g = None
        self._gbuf = None

    @staticmethod
    def _hash(buf):
        return hashlib.blake2b(buf.tobytes(), digest_size=16).digest()

    @property
    def data(self):
        if self._buf is None:
            self._buf = np.array(self._a.detach().cpu())  # writable copy
            self._digest = self._hash(self._buf)
        return self._buf

    def _dirty(self):
        """True iff the user wrote into the ``.data`` buffer since it was
        made (by content hash: no device transfer needed)."""
        return (self._buf is not None
                and self._hash(self._buf) != self._digest)

    def _current(self):
        """The blob's value: the user-written ``.data`` buffer if dirty,
        else the stored tensor."""
        return torch.tensor(self._buf) if self._dirty() else self._a

    def _refresh(self, value):
        """Take a new value.  A ``.data`` buffer the user holds stays the
        same object and takes the new value (pycaffe's persistent view)."""
        self._a = value
        self._g = self._gbuf = None
        if self._buf is not None:
            np.copyto(self._buf, np.asarray(value.detach().cpu()))
            self._digest = self._hash(self._buf)

    @property
    def diff(self):
        """The diff ``backward`` gave this blob (a host copy, made at the
        first read)."""
        if self._g is None:
            raise AttributeError(_NO_DIFF)
        if self._gbuf is None:
            self._gbuf = np.array(self._g.detach().cpu())
        return self._gbuf

    @property
    def tensor(self) -> torch.Tensor:
        """The value where it lives (the card), with no copy; a write into
        ``.data`` shows here too."""
        return self._current()

    @property
    def shape(self):
        return tuple(self._a.shape)

    @property
    def ndim(self):
        return self._a.ndim

    def __array__(self, dtype=None, copy=None):
        a = self.data  # the (possibly user-written) host buffer
        return a.astype(dtype) if dtype is not None else a

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(x.data if isinstance(x, Blob) else x for x in inputs)
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __getattr__(self, name):
        # numpy methods (argmax, mean, copy, ...) read the host copy
        if name.startswith("_"):
            raise AttributeError(name)
        if name == "diff":      # the property raised: no diff yet
            raise AttributeError(_NO_DIFF)
        return getattr(self.data, name)

    def __float__(self):
        # honor a dirty .data buffer like __array__ / __getitem__ do
        return float(self._current())

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        return self.data[idx]

    def __repr__(self):
        return f"Blob{self.shape}"


class Net:
    """``Net(prototxt, phase="test", weights="x.caffemodel")``.

    >>> net = Net(text, phase="test", device="cuda")
    >>> out = net.forward(question=q, answer=a)   # {output blob: Blob}
    >>> net.blobs["sim_cross"].data               # any top, on the host
    >>> diffs = net.backward(loss=1.0)            # {input blob: diff}
    >>> net.param_diffs["conv0"]["w"]
    >>> net.save("trained.caffemodel")
    """

    def __init__(self, prototxt: str, *, phase: str = "test",
                 weights: str | None = None, seed: int = 0, device=None):
        self.device = pycaffe_device(device)
        text = prototxt
        self._base_dir = "."
        if os.path.exists(prototxt):
            with open(prototxt) as f:
                text = f.read()
            self._base_dir = os.path.dirname(os.path.abspath(prototxt))
        self._net = GraphNet(text, phase=phase)
        self._phase = phase
        self._seed = seed
        self._feed_cache: dict = {}
        self._weights_pending = weights
        self._params = None
        self._state = None
        self._calls = 0
        self._last_inputs = None
        self._last_seed = None
        self._gen = torch.Generator(device=self.device)
        self.blobs: OrderedDict = OrderedDict()
        self.param_diffs: dict = {}

    # -- pycaffe-surface properties ---------------------------------------
    @property
    def layer_names(self):
        return [n.name for n in self._net.layers]

    @property
    def inputs(self):
        """Blobs no layer produces (the Input/data-layer tops the caller
        must feed): pycaffe's `net.inputs`."""
        produced = {t for n in self._net.layers for t in n.tops}
        wanted = {b for n in self._net.layers for b in n.bottoms}
        external = sorted(wanted - produced)
        data_tops = [t for n in self._net.layers if n.type in DATA_TYPES
                     for t in n.tops]
        return data_tops + [b for b in external if b not in data_tops]

    @property
    def outputs(self):
        return self._net.output_blob_names()

    @property
    def top_names(self):
        """layer name -> its top blob names (pycaffe.py:307)."""
        return OrderedDict((n.name, list(n.tops))
                           for n in self._net.layers)

    @property
    def bottom_names(self):
        """layer name -> its bottom blob names (pycaffe.py:308)."""
        return OrderedDict((n.name, list(n.bottoms))
                           for n in self._net.layers)

    @property
    def layers(self):
        """pycaffe's ``net.layers`` vector view: per-layer caffe-ordered,
        caffe-SHAPED parameter blobs (conv OIHW, fc (out, in): the
        caffemodel_specs layouts).  Read-only numpy snapshots; assign
        through ``self.params`` to mutate."""
        self._require_init()
        trees = {"params": self._params, "state": self._state}

        class _LayerView:
            __slots__ = ("name", "type", "blobs")

            def __init__(self, name, type_, blobs):
                self.name, self.type, self.blobs = name, type_, blobs

        by_name = {n.name: n.type for n in self._net.layers}
        out = []
        for layer, rows, _shared in self._net.caffemodel_specs(
                self._params, self._state):
            blobs = []
            for _idx, tree, keypath, to_caffe, _ in rows:
                node = trees[tree]
                for k in keypath:
                    node = node[k]
                blobs.append(to_caffe(
                    node.detach().cpu().numpy().astype(np.float32)))
            out.append(_LayerView(layer, by_name.get(layer, ""), blobs))
        return out

    @property
    def params(self):
        self._require_init()
        return self._params

    @params.setter
    def params(self, value):
        """Trees of tensors or numpy arrays (a JAX-initialised net's
        params as numpy go straight in); leaves land on the net's
        device."""
        self._params = tree_map(lambda x: _as_tensor(x, self.device), value)

    @property
    def state(self):
        self._require_init()
        return self._state

    @state.setter
    def state(self, value):
        """The BN running statistics (and other layer state), as
        ``params``."""
        self._state = tree_map(lambda x: _as_tensor(x, self.device), value)

    # -- lifecycle --------------------------------------------------------
    def _require_init(self):
        if self._params is None:
            raise RuntimeError(
                "run forward(...) once first: blob shapes (and therefore "
                "parameter shapes) are inferred from the first inputs")

    def _maybe_init(self, inputs):
        """Shape inference on the first inputs; params or state assigned
        before it are kept."""
        if self._params is not None and self._state is not None:
            return
        gen = torch.Generator().manual_seed(derive_seed(self._seed, _INIT))
        params, state = self._net.init(gen, inputs, device=self.device)
        if self._params is None:
            self._params = params
        if self._state is None:
            self._state = state
        if self._weights_pending:
            self.copy_from(self._weights_pending)
            self._weights_pending = None

    def _next_seed(self):
        self._calls += 1
        return derive_seed(self._seed, _FWD, self._calls)

    def _generator(self, seed):
        return self._gen.manual_seed(seed)

    # -- data-layer feeds --------------------------------------------------
    def set_input_arrays(self, data, labels):
        """MemoryDataLayer::Reset via pycaffe's ``net.set_input_arrays``
        (pycaffe.py:235-243, memory_data_layer.cpp:77-97): subsequent
        ``forward()`` calls slice successive ``batch_size`` rows from
        these arrays for the MemoryData layer's tops, wrapping around."""
        data = np.asarray(data)
        labels = np.asarray(labels).reshape(len(data))
        node = next((n for n in self._net.layers
                     if n.type == "MemoryData"), None)
        if node is None:
            raise ValueError("set_input_arrays needs a MemoryData layer "
                             "(pycaffe.py:238)")
        from .graph_net import _one, _p

        bs = int(_one(_p(node, "memory_data_param").get("batch_size"),
                      len(data)))
        if len(data) % bs:
            raise ValueError(
                f"source array size {len(data)} must be a multiple of "
                f"batch_size {bs} (memory_data_layer.cpp:84)")
        tops = node.tops

        def gen():
            i = 0
            while True:
                yield {tops[0]: data[i:i + bs],
                       tops[1]: labels[i:i + bs]}
                i = (i + bs) % len(data)

        self._feed_cache[node.name] = gen()

    def _feed_missing(self, inputs: dict) -> dict:
        """pycaffe's ``net.forward()`` with no arguments advances the
        net's own data layers; here the prototxt-declared sources feed
        any data-layer top the caller did not pass.  Explicit inputs
        always win."""
        from ..training.graph_solver import _build_feed

        for node in self._net.layers:
            if node.type not in DATA_TYPES or node.type == "Input":
                continue
            if all(t in inputs for t in node.tops):
                continue
            if node.name not in self._feed_cache:
                self._feed_cache[node.name] = _build_feed(
                    node.cfg, self._phase, self._seed, self._base_dir,
                    None)
            feed = self._feed_cache[node.name]
            if feed is None:  # DummyData: generated in-graph
                continue
            for k, v in next(feed).items():
                inputs.setdefault(k, _as_tensor(v, self.device))
        return inputs

    # -- forward / backward ----------------------------------------------
    def forward(self, start: str | None = None, end: str | None = None,
                **inputs):
        """Run the net on the given input blobs; updates ``self.blobs``
        with EVERY top and returns {output blob: Blob}
        (pycaffe.py:62-110's `_Net_forward`).  Data-layer tops not passed
        stream from the prototxt's declared sources.

        ``start``/``end`` name layers for a PARTIAL forward
        (pycaffe.py:78-105): the previous forward's blobs seed the range's
        bottoms (explicit inputs override), only [start, end] executes,
        and the return is the end layer's tops."""
        inputs = {k: _as_tensor(v, self.device) for k, v in inputs.items()}
        if start is not None or end is not None:
            return self._forward_range(start, end, inputs)
        # writes into net.blobs[in_].data feed the next forward
        # (pycaffe.py:97-104), and Input-layer blobs PERSIST between
        # forwards like the reference's buffers.  Explicit kwargs win; a
        # streaming data layer keeps advancing unless the user wrote into
        # one of its tops' buffers, and then all its tops feed from their
        # blobs (a write of an unchanged value is no write).
        streamed = set()
        for node in self._net.layers:
            if node.type in DATA_TYPES and node.type != "Input":
                streamed.update(node.tops)
                if any(t in self.blobs and self.blobs[t]._dirty()
                       for t in node.tops):
                    streamed.difference_update(node.tops)
        for name in self.inputs:
            b = self.blobs.get(name)
            if b is not None and name not in streamed:
                inputs.setdefault(name, _as_tensor(b._current(),
                                                   self.device))
        inputs = self._feed_missing(inputs)
        self._maybe_init(inputs)
        seed = self._next_seed()
        train = self._phase == "train"
        with torch.no_grad():
            blobs, new_state = self._net.apply(
                self._params, self._state, inputs, train=train,
                generator=self._generator(seed))
        if train:
            self._state = new_state  # BN EMA updates, like Forward would
        self._last_inputs = inputs
        self._last_seed = seed
        self.blobs = OrderedDict((k, self._refresh_blob(k, v))
                                 for k, v in blobs.items())
        return OrderedDict((k, self.blobs[k]) for k in self.outputs
                           if k in self.blobs)

    def _refresh_blob(self, name, value):
        """New value for a named blob: REUSE the existing Blob object when
        the user made its host buffer (pycaffe's ``.data`` is a persistent
        view, so scripts hold it across forwards and keep writing into
        it)."""
        old = self.blobs.get(name)
        if old is not None and old._buf is not None \
                and old._buf.shape == tuple(value.shape):
            old._refresh(value)
            return old
        return Blob(value)

    def _forward_range(self, start, end, inputs):
        """Partial forward over [start, end] (see forward)."""
        if start is not None and self._params is None:
            raise RuntimeError("forward(start=...) needs a prior full "
                               "forward (its blobs seed the range)")
        seeded = {k: _as_tensor(b._current(), self.device)
                  for k, b in self.blobs.items()}
        seeded.update(inputs)
        if self._params is None:
            self._maybe_init(seeded)
        train = self._phase == "train"
        seed = self._next_seed()
        with torch.no_grad():
            blobs, new_state = self._net.apply(
                self._params, self._state, seeded, train=train,
                generator=self._generator(seed), start=start, end=end)
        if train:
            self._state = new_state
        # keep backward()'s replay consistent with THIS forward: the seed
        # that drew this range's dropout masks, and any explicit inputs
        # the range consumed
        self._last_seed = seed
        self._last_inputs = {**(self._last_inputs or {}), **inputs}
        merged = OrderedDict(self.blobs)
        merged.update((k, self._refresh_blob(k, v))
                      for k, v in blobs.items())
        self.blobs = merged
        if end is not None:
            node = next(n for n in self._net.layers if n.name == end)
            names = [t for t in node.tops if t in blobs]
        else:
            names = [k for k in self.outputs if k in blobs]
        return OrderedDict((k, self.blobs[k]) for k in names)

    def forward_all(self, **input_batches):
        """pycaffe's `_Net_forward_all` minus the batch rechunking: one
        forward over the full arrays."""
        return self.forward(**input_batches)

    def backward(self, start: str | None = None, end: str | None = None,
                 **top_diffs):
        """Cotangents for named top blobs -> diffs of FLOAT input blobs
        (host arrays, also on those blobs' ``.diff``); parameter gradients
        land in ``self.param_diffs`` (`_Net_backward`,
        pycaffe.py:111-157).  The last forward is replayed under autograd
        with its random draws.

        ``start``/``end`` follow pycaffe's backward orientation: start =
        the LATER layer the cotangents enter at, end = the earlier layer
        to stop after.  Diffs are then taken w.r.t. the float blobs
        FEEDING the [end, start] forward range (the previous forward's
        blobs seed everything outside it)."""
        if self._last_inputs is None:
            raise RuntimeError("backward() needs a prior forward()")
        if not top_diffs:
            raise ValueError("pass at least one top diff, e.g. "
                             "backward(loss=1.0)")
        names = sorted(top_diffs)
        net, train = self._net, self._phase == "train"
        if start is not None or end is not None:
            # forward-range view: lo = end (earlier), hi = start (later)
            lo_name, hi_name = end, start
            produced = set()
            lo = 0 if lo_name is None else net.layer_index(lo_name)
            hi = (len(net.layers) - 1 if hi_name is None
                  else net.layer_index(hi_name))
            for node in net.layers[lo:hi + 1]:
                # in-place tops (top == bottom) keep their seed: the range
                # consumes the stored value
                produced.update(t for t in node.tops
                                if t not in node.bottoms)
            seeds = {k: _as_tensor(b._current(), self.device)
                     for k, b in self.blobs.items() if k not in produced}
            seeds.update(self._last_inputs)
        else:
            lo_name = hi_name = None
            seeds = dict(self._last_inputs)
        floats = {k: v.detach().clone().requires_grad_(True)
                  for k, v in seeds.items() if v.is_floating_point()}
        others = {k: v for k, v in seeds.items() if k not in floats}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(self._params)]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), self._params)
        with torch.enable_grad():
            blobs, _ = net.apply(params, self._state, {**others, **floats},
                                 train=train,
                                 generator=self._generator(self._last_seed),
                                 start=lo_name, end=hi_name)
            outs = [blobs[n] for n in names]
            cots = [_as_tensor(top_diffs[n], self.device)
                    .to(o.dtype).broadcast_to(o.shape)
                    for n, o in zip(names, outs)]
            wrt = leaves + list(floats.values())
            grads = torch.autograd.grad(outs, wrt, grad_outputs=cots,
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, wrt)]
        it = iter(grads[:len(leaves)])
        self.param_diffs = tree_map(lambda _: next(it), self._params)
        diffs = {}
        for k, g in zip(floats, grads[len(leaves):]):
            blob = self.blobs.get(k)
            if blob is not None:
                blob._g, blob._gbuf = g, None
                diffs[k] = blob.diff
            else:
                diffs[k] = g.detach().cpu().numpy()
        return diffs

    # -- weights IO -------------------------------------------------------
    def save(self, path: str):
        """`net.save(path)`: .caffemodel / .caffemodel.h5 by extension
        (Net::ToProto / ToHDF5)."""
        from ..utils.caffemodel import (save_caffemodel_binaryproto,
                                        save_caffemodel_h5)

        self._require_init()
        specs = self._net.caffemodel_specs(self._params, self._state)
        save = (save_caffemodel_h5 if path.endswith((".h5", ".hdf5"))
                else save_caffemodel_binaryproto)
        return save(path, self._params, self._state, specs=specs)

    def copy_from(self, path: str):
        """`CopyTrainedLayersFrom`: name/shape-checked partial load
        (binaryproto or HDF5 by the file's magic)."""
        from ..utils.caffemodel import load_caffemodel_auto

        self._require_init()
        specs = self._net.caffemodel_specs(self._params, self._state)
        self._params, self._state, report = load_caffemodel_auto(
            path, self._params, self._state, specs=specs)
        return report
