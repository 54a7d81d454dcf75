"""Python net-specification DSL: the pycaffe ``NetSpec`` equivalent.

The reference builds its nets in Python through ``caffe.net_spec``
(python/caffe/net_spec.py:28-220): ``L.<Type>(*bottoms, **kwargs)``
returns Top handles, a ``NetSpec`` names tops by attribute assignment,
``P.<Message>.<ENUM>`` supplies enum constants, and ``to_proto``
serializes the closure of assigned tops into a ``NetParameter`` — the
MMS QA script's ``make_net`` is written entirely in it
(examples/trec_qa_w2v_mms/do_trec_qa_clean.py:377-605).

This is the port's reading: instead of protobuf reflection the DSL
emits prototxt *text* (the interchange format everything here already
speaks), which `GraphNet`/`GraphSolver` execute in PyTorch and
`parse_prototxt` round-trips.  Behavioral parity notes:

* kwargs route into the layer type's ``<snake>_param`` message when the
  type has one (the reference derives the mapping from protobuf
  descriptors; here it is the explicit `_PARAM_MSG` table covering every
  type `GraphNet` executes).  Keys ending in ``param`` and the standard
  layer-level fields (``name``/``loss_weight``/``param``/``include``/
  ``exclude``/``propagate_down``) stay at the layer level, exactly like
  ``assign_proto``'s fallback chain.
* dicts become nested messages, lists repeated fields, and a scalar
  against a known repeated field is accepted as a one-element list
  (``assign_proto``'s convenience rule).
* ``ntop=0`` returns the Function itself (Silence-style sinks);
  ``in_place=True`` writes tops = bottoms.
* unnamed intermediate tops get ``<Type><n>`` autonames with a shared
  per-type counter (``Function._get_name``); assigned NetSpec attributes
  name both the blob and the producing layer.
* ``P.Pooling.MAX`` returns an `Enum` token serialized bare (unquoted),
  matching text-format enum syntax.
"""

from __future__ import annotations

from collections import Counter, OrderedDict

__all__ = ["L", "P", "NetSpec", "Enum", "Top", "Function", "to_proto",
           "layers", "params"]


from .prototxt import EnumToken as Enum  # noqa: E402  (re-export)


# layer type -> its parameter message field; every type GraphNet executes
# that HAS a message (graph_net.py's `_p` calls).  Types absent here keep
# kwargs at the layer level only when they are standard LayerParameter
# fields — anything else is an error telling the caller to pass an
# explicit `*_param` dict (the reference's assign_proto raises the same
# way once protobuf rejects the field).
_PARAM_MSG = {
    "Accuracy": "accuracy_param",
    "ArgMax": "argmax_param",
    "AUC": "auc_param",
    "BatchNorm": "batch_norm_param",
    "Bias": "bias_param",
    "BN": "bn_param",
    "Concat": "concat_param",
    "ContrastiveLoss": "contrastive_loss_param",
    "Convolution": "convolution_param",
    "Deconvolution": "convolution_param",
    "Crop": "crop_param",
    "Data": "data_param",
    "Dropout": "dropout_param",
    "DummyData": "dummy_data_param",
    "Eltwise": "eltwise_param",
    "ELU": "elu_param",
    "Embed": "embed_param",
    "Exp": "exp_param",
    "Flatten": "flatten_param",
    "FM": "fm_param",
    "HDF5Data": "hdf5_data_param",
    "HDF5Output": "hdf5_output_param",
    "HingeLoss": "hinge_loss_param",
    "ImageData": "image_data_param",
    "InfogainLoss": "infogain_loss_param",
    "InnerProduct": "inner_product_param",
    "Input": "input_param",
    "Log": "log_param",
    "LRN": "lrn_param",
    "LSTM": "recurrent_param",
    "MAP": "map_param",
    "MemoryData": "memory_data_param",
    "MRR": "mrr_param",
    "MVN": "mvn_param",
    "PairImageData": "pair_image_data_param",
    "PairRankLoss": "pair_rank_loss_param",
    "Parameter": "parameter_param",
    "Pooling": "pooling_param",
    "Power": "power_param",
    "PReLU": "prelu_param",
    "Python": "python_param",
    "RankAccuracy": "rank_accuracy_param",
    "Reduction": "reduction_param",
    "ReLU": "relu_param",
    "Reshape": "reshape_param",
    "RNN": "recurrent_param",
    "Scale": "scale_param",
    "Sigmoid": "sigmoid_param",
    "SimCross": "sim_cross_param",
    "SimMatrix": "sim_matrix_param",
    "Slice": "slice_param",
    "Softmax": "softmax_param",
    "SPP": "spp_param",
    "TanH": "tanh_param",
    "Threshold": "threshold_param",
    "Tile": "tile_param",
    "WindowData": "window_data_param",
}

# LayerParameter-level fields kwargs may set directly
_TOP_LEVEL = frozenset({
    "name", "bottom", "top", "phase", "loss_weight", "param",
    "propagate_down", "include", "exclude", "transform_param",
})


def register_param_message(type_name: str, param_field: str) -> None:
    """Extension hook pairing `graph_net.register_layer`: teach the DSL
    where a custom layer type's kwargs route."""
    _PARAM_MSG[type_name] = param_field


# ---------------------------------------------------------------------------
# prototxt emission (generic inverse of prototxt.parse_prototxt)
# ---------------------------------------------------------------------------

class ProtoDict(dict):
    """A parse_prototxt-shaped dict whose ``str()`` is the prototxt
    text — so the pycaffe idiom ``f.write(str(n.to_proto()))``
    (net_spec.py usage throughout the reference examples) works
    verbatim while dict consumers keep structured access."""

    def __str__(self) -> str:
        return dict_to_prototxt(self)


def dict_to_prototxt(d: dict) -> str:
    """Nested dict (parse_prototxt's shape) -> prototxt text.  One
    emitter serves the DSL and the upgrade tool: ``Enum`` values and
    known enum FIELDS serialize bare, all other strings quoted
    (prototxt.emit_prototxt)."""
    from .prototxt import emit_prototxt

    return emit_prototxt(d) + "\n"


# ---------------------------------------------------------------------------
# the DSL core
# ---------------------------------------------------------------------------

class Top:
    """One output blob of a Function (net_spec.py Top)."""

    def __init__(self, fn: "Function", n: int):
        self.fn = fn
        self.n = n

    def to_proto(self):
        return to_proto(self)

    def _to_proto(self, layers_od, names, autonames):
        return self.fn._to_proto(layers_od, names, autonames)


class Function:
    """A layer invocation: type, input Tops, kwargs (net_spec.py
    Function).  ``ntop`` controls the number of Tops returned; ``in_place``
    reuses the bottom names as tops."""

    def __init__(self, type_name: str, inputs, params_kw: dict):
        self.type_name = type_name
        self.inputs = inputs
        self.params = dict(params_kw)
        self.ntop = int(self.params.pop("ntop", 1))
        self.in_place = bool(self.params.pop("in_place", False))
        for inp in inputs:
            if not isinstance(inp, Top):
                raise TypeError(
                    f"{type_name}: positional args must be Tops of prior "
                    f"layers, got {type(inp).__name__} (pass data through "
                    f"an Input/HDF5Data layer)")
        self.tops = tuple(Top(self, n) for n in range(self.ntop))

    # -- naming (Function._get_name / _get_top_name) -----------------------
    def _get_name(self, names, autonames):
        if self not in names and self.ntop > 0:
            names[self] = self._get_top_name(self.tops[0], names, autonames)
        elif self not in names:
            autonames[self.type_name] += 1
            names[self] = self.type_name + str(autonames[self.type_name])
        return names[self]

    def _get_top_name(self, top, names, autonames):
        if top not in names:
            autonames[top.fn.type_name] += 1
            names[top] = top.fn.type_name + str(autonames[top.fn.type_name])
        return names[top]

    # -- kwargs -> layer dict ---------------------------------------------
    def _route_params(self, layer: dict) -> None:
        msg = _PARAM_MSG.get(self.type_name)
        # explicit <type>_param dicts first (COPIED: routing direct
        # kwargs into them must neither be order-dependent nor mutate a
        # dict the caller may reuse across layers), then direct kwargs
        # merge in — pycaffe's assign_proto merges either order too
        for k, v in self.params.items():
            if k.endswith("param") or k in _TOP_LEVEL:
                layer[k] = dict(v) if isinstance(v, dict) else v
        for k, v in self.params.items():
            if k.endswith("param") or k in _TOP_LEVEL:
                continue
            if msg is not None:
                layer.setdefault(msg, {})[k] = v
            else:
                raise ValueError(
                    f"layer type {self.type_name!r} has no parameter "
                    f"message for kwarg {k!r}; pass an explicit "
                    f"<type>_param=dict(...) instead")

    def _to_proto(self, layers_od, names, autonames):
        if self in layers_od:
            return
        bottom_names = []
        for inp in self.inputs:
            inp._to_proto(layers_od, names, autonames)
            bottom_names.append(layers_od[inp.fn]["top"][inp.n])
        layer: dict = {"name": None, "type": self.type_name}
        layer["bottom"] = list(bottom_names)
        if self.in_place:
            layer["top"] = list(bottom_names)
        else:
            layer["top"] = [self._get_top_name(t, names, autonames)
                            for t in self.tops]
        layer["name"] = self._get_name(names, autonames)
        self._route_params(layer)
        if not layer["bottom"]:
            del layer["bottom"]
        if not layer["top"]:
            del layer["top"]
        layers_od[self] = layer


class NetSpec:
    """Attribute-assigned Tops -> NetParameter (net_spec.py NetSpec).

    >>> n = NetSpec()
    >>> n.data, n.label = L.HDF5Data(batch_size=50, source="x.txt", ntop=2)
    >>> n.ip = L.InnerProduct(n.data, num_output=10)
    >>> n.loss = L.SoftmaxWithLoss(n.ip, n.label)
    >>> text = n.to_prototxt()        # feed to GraphNet / GraphSolver
    """

    def __init__(self):
        super().__setattr__("tops", OrderedDict())

    def __setattr__(self, name, value):
        self.tops[name] = value

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            return self.tops[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_proto(self) -> dict:
        """NetParameter as a parse_prototxt-shaped dict."""
        names = {v: k for k, v in self.tops.items()}
        autonames = Counter()
        layers_od = OrderedDict()
        for _name, top in self.tops.items():
            top._to_proto(layers_od, names, autonames)
        return ProtoDict({"layer": list(layers_od.values())})

    def to_prototxt(self, *, name: str | None = None) -> str:
        d = self.to_proto()
        head = {"name": name, **d} if name else d
        return dict_to_prototxt(head)


def to_proto(*tops) -> dict:
    """Closure of the given Tops with autonames only (module-level
    to_proto, net_spec.py:44-54)."""
    layers_od = OrderedDict()
    autonames = Counter()
    for top in tops:
        top.fn._to_proto(layers_od, {}, autonames)
    return ProtoDict({"layer": list(layers_od.values())})


def to_prototxt(*tops) -> str:
    return dict_to_prototxt(to_proto(*tops))


class Layers:
    """``L.<Type>(*bottoms, **kwargs)`` pseudo-module."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def layer_fn(*args, **kwargs):
            fn = Function(name, args, kwargs)
            if fn.ntop == 0:
                return fn
            if fn.ntop == 1:
                return fn.tops[0]
            return fn.tops

        layer_fn.__name__ = name
        return layer_fn


class Parameters:
    """``P.<Message>.<ENUM>`` pseudo-module: yields bare enum tokens
    (P.Pooling.MAX -> Enum("MAX"))."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        class _Msg:
            def __getattr__(self, enum_name):
                if enum_name.startswith("__"):
                    raise AttributeError(enum_name)
                return Enum(enum_name)

        return _Msg()


L = layers = Layers()
P = params = Parameters()
