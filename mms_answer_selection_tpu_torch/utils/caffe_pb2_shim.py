"""``caffe.proto.caffe_pb2`` work-alike: protobuf-message-style classes
over the :mod:`.proto_wire` schema tables.

Ported pycaffe scripts build Datums and BlobProtos programmatically and
call ``SerializeToString``/``ParseFromString`` on them
(python/caffe/io.py:41-97 does exactly this); no protobuf runtime or
generated ``caffe_pb2`` exists in this environment, so this module
provides the message-object surface those scripts touch:

* attribute get/set with proto-style defaults (0 / "" / False / b"")
* repeated fields as live lists (``msg.float_data.append(x)``,
  ``net.layer.add(name="ip")``)
* sub-messages auto-vivify on write (reading one does NOT mark it
  present, matching proto2 semantics — an untouched child emits
  nothing)
* ``SerializeToString`` / ``ParseFromString`` / ``CopyFrom`` / ``==``

Scope: the messages pycaffe scripts construct — Datum, BlobProto,
BlobShape, BlobProtoVector, FillerParameter, NetParameter,
LayerParameter (+ every sub-message those reference transitively via
proto_wire's tables).  SolverParameter is text-format-only in this
framework (utils/prototxt.py) and is not exposed here.

Internally a message wraps the SAME dict shape `proto_wire` and
`parse_prototxt` use, so shim objects, text prototxts, and binary wire
bytes all interconvert losslessly.
"""

from __future__ import annotations

from . import proto_wire as _pw

__all__ = ["Datum", "BlobProto", "BlobShape", "BlobProtoVector",
           "FillerParameter", "NetParameter", "LayerParameter",
           "V1LayerParameter", "TRAIN", "TEST", "message_for",
           "Message"]

# Phase enum values (caffe.proto `enum Phase { TRAIN = 0; TEST = 1; }`)
TRAIN = 0
TEST = 1

# fields that are `repeated` in caffe.proto, per schema table name.
# (proto_wire's tables don't mark arity — its decode convention is
# scalar-until-second-occurrence — so the message surface needs this.)
_REPEATED = {
    "Datum": {"float_data"},
    "BlobProto": {"data", "diff"},
    "BlobShape": {"dim"},
    "BlobProtoVector": {"blobs"},
    "Net": {"layer", "layers", "input", "input_dim", "input_shape"},
    "Layer": {"bottom", "top", "param", "blobs", "include", "exclude",
              "loss_weight", "propagate_down"},
    "V1Layer": {"bottom", "top", "param", "blobs", "include", "exclude",
                "loss_weight", "blobs_lr", "weight_decay",
                "blob_share_mode"},
    "V0Layer": {"blobs", "blobs_lr", "weight_decay"},
    "Convolution": {"kernel_size", "stride", "pad", "dilation"},
    "Transform": {"mean_value"},
    "Eltwise": {"coeff"},
    "Slice": {"slice_point"},
    "DummyData": {"data_filler", "shape", "num", "channels", "height",
                  "width"},
    "Input": {"shape"},
    "NetState": {"stage"},
    "NetStateRule": {"stage", "not_stage"},
    "Crop": {"offset"},
}

_SCALAR_DEFAULTS = {"i": 0, "b": False, "f": 0.0, "s": "", "B": b"",
                    "pi": 0, "pf": 0.0}


def _is_msg(kind) -> bool:
    return isinstance(kind, tuple) and kind[0] == "m"


class _RepeatedScalar:
    """Live list view of a repeated scalar field (appends materialize
    the parent)."""

    __slots__ = ("_owner", "_name")

    def __init__(self, owner, name):
        self._owner, self._name = owner, name

    def _list(self, create=False):
        d = self._owner._d
        v = d.get(self._name)
        if v is None:
            if not create:
                return []
            self._owner._materialize()
            d = self._owner._d
            d[self._name] = []
            return d[self._name]
        if not isinstance(v, list):
            d[self._name] = [v]  # decode stores singles as scalars
            return d[self._name]
        return v

    def append(self, v):
        self._list(create=True).append(v)

    def extend(self, vs):
        self._list(create=True).extend(vs)

    def __getitem__(self, i):
        return self._list()[i]

    def __setitem__(self, i, v):
        self._list(create=True)[i] = v

    def __len__(self):
        return len(self._list())

    def __iter__(self):
        return iter(self._list())

    def __eq__(self, other):
        return list(self._list()) == list(other)

    def __repr__(self):
        return repr(self._list())


class _RepeatedMessage:
    """Live list view of a repeated sub-message field: ``add(**kw)``
    appends and returns a child message."""

    __slots__ = ("_owner", "_name", "_schema")

    def __init__(self, owner, name, schema):
        self._owner, self._name, self._schema = owner, name, schema

    def _list(self, create=False):
        d = self._owner._d
        v = d.get(self._name)
        if v is None:
            if not create:
                return []
            self._owner._materialize()
            d = self._owner._d
            d[self._name] = []
            return d[self._name]
        if not isinstance(v, list):
            d[self._name] = [v]
            return d[self._name]
        return v

    def add(self, **kw):
        child_d: dict = {}
        self._list(create=True).append(child_d)
        msg = Message(self._schema, child_d)
        for k, v in kw.items():
            setattr(msg, k, v)
        return msg

    def __getitem__(self, i):
        return Message(self._schema, self._list()[i])

    def __len__(self):
        return len(self._list())

    def __iter__(self):
        for d in self._list():
            yield Message(self._schema, d)


class Message:
    """One protobuf-style message view over a plain field dict."""

    __slots__ = ("_schema", "_d", "_attach")

    def __init__(self, schema: str, _data: dict | None = None,
                 _attach=None, **kw):
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_d", {} if _data is None else _data)
        object.__setattr__(self, "_attach", _attach)
        for k, v in kw.items():
            setattr(self, k, v)

    # -- presence plumbing -------------------------------------------------
    def _materialize(self):
        """First write into an auto-vivified child attaches its dict to
        the parent (reading a sub-message must not mark it present)."""
        attach = self._attach
        if attach is not None:
            object.__setattr__(self, "_attach", None)
            attach(self._d)

    def _field(self, name):
        spec = _pw._REVERSE[self._schema].get(name)
        if spec is None:
            raise AttributeError(
                f"{self._schema} has no field {name!r}")
        return spec

    # -- attribute surface ---------------------------------------------------
    def __getattr__(self, name):
        _num, kind = self._field(name)
        repeated = name in _REPEATED.get(self._schema, ())
        if _is_msg(kind):
            if repeated:
                return _RepeatedMessage(self, name, kind[1])
            v = self._d.get(name)
            if isinstance(v, list):  # tolerate decoded over-occurrence
                v = v[-1]
            if v is not None:
                return Message(kind[1], v)

            def attach(child_d, self=self, name=name):
                self._materialize()
                self._d[name] = child_d

            return Message(kind[1], _attach=attach)
        if repeated:
            return _RepeatedScalar(self, name)
        v = self._d.get(name)
        if isinstance(v, list):
            v = v[-1]
        if v is None:
            if isinstance(kind, tuple):  # enum default: first value
                return 0
            return _SCALAR_DEFAULTS[kind]
        return v

    def __setattr__(self, name, value):
        _num, kind = self._field(name)
        self._materialize()
        repeated = name in _REPEATED.get(self._schema, ())
        if repeated:
            if _is_msg(kind):
                raise AttributeError(
                    f"{name} is a repeated message: use .add()")
            self._d[name] = list(value)
            return
        if _is_msg(kind):
            self._d[name] = dict(value._d if isinstance(value, Message)
                                 else value)
            return
        self._d[name] = bytes(value) if kind == "B" else value

    def HasField(self, name) -> bool:
        self._field(name)
        return name in self._d

    def ClearField(self, name):
        self._d.pop(name, None)

    # -- wire ----------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        return _pw._encode(self._d, self._schema)

    def ParseFromString(self, data: bytes):
        self._materialize()
        self._d.clear()
        self._d.update(_pw._decode(bytes(data), self._schema))
        return self

    def CopyFrom(self, other: "Message"):
        import copy

        self._materialize()
        self._d.clear()
        self._d.update(copy.deepcopy(other._d))

    def to_dict(self) -> dict:
        """The underlying parse_prototxt-shaped dict (shared, live)."""
        return self._d

    def __eq__(self, other):
        return (isinstance(other, Message)
                and other._schema == self._schema
                and other._d == self._d)

    def __repr__(self):
        return f"{self._schema}({self._d!r})"


def message_for(schema: str):
    """A constructor for any proto_wire schema name."""
    if schema not in _pw._SCHEMAS:
        raise KeyError(f"unknown message schema {schema!r}")

    def ctor(**kw):
        return Message(schema, **kw)

    ctor.__name__ = schema
    return ctor


def _named(public_name: str, schema: str):
    def ctor(**kw):
        return Message(schema, **kw)

    ctor.__name__ = public_name
    return ctor


Datum = _named("Datum", "Datum")
BlobProto = _named("BlobProto", "BlobProto")
BlobShape = _named("BlobShape", "BlobShape")
BlobProtoVector = _named("BlobProtoVector", "BlobProtoVector")
FillerParameter = _named("FillerParameter", "Filler")
NetParameter = _named("NetParameter", "Net")
LayerParameter = _named("LayerParameter", "Layer")
V1LayerParameter = _named("V1LayerParameter", "V1Layer")
