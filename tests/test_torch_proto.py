"""The protobuf wire codec (``utils/proto_wire.py``), the message-style
``caffe_pb2`` shim (``utils/caffe_pb2_shim.py``) and ``upgrade --binary``
of the port against the JAX package's, on CPU.

Everything here is held exactly: the same dict encodes to the same bytes
in both packages, the same bytes decode to the same dict (or raise the
same exception type), the shim's messages serialize to the same bytes, and
the CLI writes the same files.  The random messages are
``tests/test_proto_wire_fuzz.py``'s, drawn through hypothesis (derandomized,
so a run is repeatable) and from seeded generators per schema table.
"""

import random
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mms_answer_selection_tpu import cli as jcli
from mms_answer_selection_tpu.utils import caffe_pb2_shim as jpb
from mms_answer_selection_tpu.utils import proto_wire as jpw
from mms_answer_selection_tpu_torch import cli as tcli
from mms_answer_selection_tpu_torch.utils import caffe_pb2_shim as tpb
from mms_answer_selection_tpu_torch.utils import proto_wire as tpw
from tests.test_proto_wire_fuzz import _normalize, _rand_message
from tests.test_upgrade_binary import _v0_net_bytes, _v1_net_bytes

FUZZ = settings(max_examples=60, derandomize=True, deadline=None,
                database=None, suppress_health_check=[HealthCheck.too_slow])
DECODE_ERRORS = (ValueError, IndexError, struct.error, OverflowError)


def _decoded(fn, wire):
    """``fn(wire)``, or the type of the exception it raised."""
    try:
        return fn(wire)
    except DECODE_ERRORS as e:
        return type(e)


def test_schema_tables_are_jax_s():
    assert tpw._SCHEMAS == jpw._SCHEMAS


@pytest.mark.parametrize("msg", sorted(jpw._SCHEMAS))
def test_every_message_encodes_and_decodes_as_jax(msg):
    rng = random.Random(msg)
    for _ in range(25):
        d = _rand_message(rng, msg)
        wire = jpw._encode(d, msg)
        assert tpw._encode(d, msg) == wire, d
        assert _normalize(tpw._decode(wire, msg)) == \
            _normalize(jpw._decode(wire, msg))


@FUZZ
@given(st.integers(0, 2**32 - 1))
def test_random_nets_encode_as_jax(seed):
    d = _rand_message(random.Random(seed), "Net")
    wire = jpw.encode_net_binary(d)
    assert tpw.encode_net_binary(d) == wire
    assert tpw.decode_net_binary(wire) == jpw.decode_net_binary(wire)


@FUZZ
@given(st.binary(max_size=64))
def test_garbage_decodes_or_fails_as_jax(blob):
    assert _decoded(tpw.decode_net_binary, blob) == \
        _decoded(jpw.decode_net_binary, blob)


@FUZZ
@given(st.integers(0, 2**32 - 1), st.floats(0, 1))
def test_truncated_nets_decode_or_fail_as_jax(seed, frac):
    wire = jpw.encode_net_binary(_rand_message(random.Random(seed), "Net"))
    cut = wire[:int(len(wire) * frac)]
    assert _decoded(tpw.decode_net_binary, cut) == \
        _decoded(jpw.decode_net_binary, cut)


@pytest.mark.parametrize("era", ["v0", "v1"])
def test_legacy_nets_decode_upgrade_and_report_as_jax(era):
    from mms_answer_selection_tpu.utils.prototxt import \
        upgrade_net_prototxt as j_up
    from mms_answer_selection_tpu_torch.utils.prototxt import \
        upgrade_net_prototxt as t_up

    raw = _v0_net_bytes() if era == "v0" else _v1_net_bytes()
    jd, td = jpw.decode_net_binary(raw), tpw.decode_net_binary(raw)
    assert td == jd
    assert tpw.collect_dropped_unknowns(td) == \
        jpw.collect_dropped_unknowns(jd)
    ju, tu = j_up(jd), t_up(td)
    assert tu == ju
    assert tpw.encode_net_binary(tu) == jpw.encode_net_binary(ju)
    assert tpw.strip_blobs(tu) == jpw.strip_blobs(ju)


def test_encode_refuses_legacy_as_jax():
    for pw in (jpw, tpw):
        with pytest.raises(ValueError, match="upgrade"):
            pw.encode_net_binary({"layers": [{"name": "x"}]})


# --------------------------------------------------------- caffe_pb2 shim

def _datum(pb):
    d = pb.Datum()
    d.channels, d.height, d.width = 2, 3, 4
    d.label = 7
    d.data = bytes(range(24))
    d.float_data.extend([1.5, -2.0])
    return d


def _blob(pb):
    b = pb.BlobProto()
    b.shape.dim.extend([2, 3])
    b.data.extend(np.linspace(-1, 1, 6).astype(np.float32).tolist())
    b.diff.extend([0.25] * 6)
    return b


def _vector(pb):
    v = pb.BlobProtoVector()
    for k in range(3):
        b = v.blobs.add()
        b.num, b.channels, b.height, b.width = 1, 1, 1, k + 1
        b.data.extend([float(k)] * (k + 1))
    return v


def _net(pb):
    n = pb.NetParameter()
    n.name = "shim"
    la = n.layer.add()
    la.name, la.type = "ip", "InnerProduct"
    la.bottom.append("data")
    la.top.append("ip")
    la.inner_product_param.num_output = 4
    la.inner_product_param.weight_filler.type = "xavier"
    la.include.add().phase = pb.TRAIN
    p = la.param.add()
    p.lr_mult, p.decay_mult = 1.0, 0.0
    return n


@pytest.mark.parametrize("build", [_datum, _blob, _vector, _net])
def test_shim_messages_serialize_as_jax(build):
    j, t = build(jpb), build(tpb)
    wire = j.SerializeToString()
    assert t.SerializeToString() == wire
    back = tpb.message_for(t._schema)().ParseFromString(wire)
    assert back.SerializeToString() == wire
    assert _normalize(back.to_dict()) == _normalize(
        jpb.message_for(j._schema)().ParseFromString(wire).to_dict())


def test_shim_message_for_every_schema_defaults_as_jax():
    for name in sorted(jpw._SCHEMAS):
        j, t = jpb.message_for(name)(), tpb.message_for(name)()
        assert t.SerializeToString() == j.SerializeToString() == b""
        for field, kind in jpw._SCHEMAS[name].values():
            if kind in ("i", "b", "f", "s", "B") \
                    and field not in jpb._REPEATED.get(name, ()):
                assert getattr(t, field) == getattr(j, field), (name, field)


def test_shim_constants_are_jax_s():
    assert (tpb.TRAIN, tpb.TEST) == (jpb.TRAIN, jpb.TEST)


# ------------------------------------------------------- upgrade --binary

@pytest.mark.parametrize("era", ["v0", "v1"])
@pytest.mark.parametrize("out", ["modern.caffemodel", "modern.prototxt"])
def test_upgrade_binary_writes_jax_s_files(tmp_path, capsys, era, out):
    raw = _v0_net_bytes() if era == "v0" else _v1_net_bytes()
    (tmp_path / "legacy.caffemodel").write_bytes(raw)
    got = {}
    for tag, main in (("jax", jcli.main), ("port", tcli.main)):
        (tmp_path / tag).mkdir()
        main(["upgrade", "--binary", str(tmp_path / "legacy.caffemodel"),
              str(tmp_path / tag / out)])
        got[tag] = ((tmp_path / tag / out).read_bytes(),
                    capsys.readouterr().out.replace(str(tmp_path / tag),
                                                    "DIR"))
    assert got["port"] == got["jax"]


def test_upgrade_binary_needs_an_output_as_jax(tmp_path):
    (tmp_path / "x.caffemodel").write_bytes(b"\n\x01n")
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match="output"):
            main(["upgrade", "--binary", str(tmp_path / "x.caffemodel")])
