"""The port's matcaffe bridge against the JAX package's: one scripted MEX
command stream sent to both ``MatBridge``s, the replies compared (handles,
attribute structs and shapes exactly, arrays within 1e-5 of the array's
largest value: the same weights, float32 sums in another order; saved
.caffemodel files byte for byte), the same stream over the wire to
``serve_matcaffe``, and the static check of ``tests/test_matlab_client.py``
pointed at the port's bridge.

Both packages draw initial weights from their own generators, so the
stream writes every parameter blob and input with ``blob_set_data`` from
one seeded numpy source before it reads anything back, and the solver's net
draws constant DummyData.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from mms_answer_selection_tpu import matcaffe as JM
from mms_answer_selection_tpu_torch import matcaffe as TM

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5

DEPLOY = """
name: "deploy" force_backward: true
input: "data" input_shape { dim: 3 dim: 2 dim: 5 dim: 4 }
layer { type: "Convolution" name: "conv" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 2 pad: 1 } }
layer { type: "ReLU" name: "relu" bottom: "conv" top: "relu" }
layer { type: "Pooling" name: "pool" bottom: "relu" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { type: "InnerProduct" name: "ip" bottom: "pool" top: "ip"
  inner_product_param { num_output: 5 } }
layer { type: "Softmax" name: "prob" bottom: "ip" top: "prob" }
"""

TRAIN = """
name: "train" force_backward: true
layer { type: "DummyData" name: "data" top: "data" top: "label"
  dummy_data_param { num: 4 channels: 2 height: 3 width: 3
    num: 4 channels: 1 height: 1 width: 1
    data_filler { type: "constant" value: 0.5 }
    data_filler { type: "constant" value: 1 } } }
layer { type: "Convolution" name: "conv" bottom: "data" top: "conv"
  convolution_param { num_output: 3 kernel_size: 2 } }
layer { type: "InnerProduct" name: "ip" bottom: "conv" top: "ip"
  inner_product_param { num_output: 3 } }
layer { type: "SoftmaxWithLoss" name: "loss" bottom: "ip" bottom: "label"
  top: "loss" }
"""

SOLVER = """
net: "%s"
base_lr: 0.05 momentum: 0.9 weight_decay: 0.0005 lr_policy: "fixed"
display: 0 max_iter: 100 snapshot_after_train: false
"""


def _same(got, want, path="reply"):
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, path
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
        assert float(np.abs(got - want).max()) <= TOL * scale, path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def _stream(call, tmp: Path, tag: str):
    """The scripted command stream; ``call(cmd, *args)`` is a bridge or a
    client.  Returns every reply, in order."""
    rng = np.random.default_rng(21)
    out = []

    def c(*a):
        r = call(*a)
        out.append((a[0], r))
        return r

    c("set_mode_cpu")
    c("get_init_key")
    c("version")
    deploy, train, solver = tmp / "deploy.prototxt", tmp / "train.prototxt", \
        tmp / "solver.prototxt"
    h = c("get_net", str(deploy), "test")
    attr = c("net_get_attr", h)
    for lh in attr["hLayer_layers"]:
        c("layer_get_type", lh)
        for bh in c("layer_get_attr", lh)["hBlob_blobs"]:
            shape = [int(s) for s in c("blob_get_shape", bh)]
            c("blob_set_data", bh, rng.normal(size=shape).astype(np.float32))
    data = attr["hBlob_blobs"][attr["input_blob_indices"][0]]
    c("blob_set_data", data, rng.normal(size=(4, 5, 2, 3)).astype(
        np.float32))
    c("net_forward", h)
    for bh in attr["hBlob_blobs"]:
        c("blob_get_shape", bh)
        c("blob_get_data", bh)
    out_blob = attr["hBlob_blobs"][attr["output_blob_indices"][0]]
    c("blob_set_diff", out_blob, rng.normal(size=(5, 3)).astype(np.float32))
    c("net_backward", h)
    c("blob_get_diff", data)
    for lh in attr["hLayer_layers"]:
        for bh in c("layer_get_attr", lh)["hBlob_blobs"]:
            c("blob_get_diff", bh)
    c("net_save", h, str(tmp / f"{tag}.caffemodel"))
    c("blob_reshape", data, np.array([[4, 5, 2, 2]], np.float64))
    c("blob_set_data", data, rng.normal(size=(4, 5, 2, 2)).astype(
        np.float32))
    c("net_forward", h)
    c("blob_get_data", out_blob)
    c("net_copy_from", h, str(tmp / f"{tag}.caffemodel"))

    hs = c("get_solver", str(solver))
    sattr = c("solver_get_attr", hs)
    nattr = c("net_get_attr", sattr["hNet_net"])
    for lh in nattr["hLayer_layers"]:
        for bh in c("layer_get_attr", lh)["hBlob_blobs"]:
            shape = [int(s) for s in c("blob_get_shape", bh)]
            c("blob_set_data", bh,
              0.3 * rng.normal(size=shape).astype(np.float32))
    c("solver_step", hs, 10)
    c("solver_get_iter", hs)
    for lh in nattr["hLayer_layers"]:
        for bh in c("layer_get_attr", lh)["hBlob_blobs"]:
            c("blob_get_data", bh)
    c("net_forward", sattr["hNet_net"])
    c("blob_get_data", nattr["hBlob_blobs"][nattr["blob_names"].index(
        "loss")])

    mean = rng.random((3, 4, 2)).astype(np.float32)
    c("write_mean", mean, str(tmp / f"{tag}.binaryproto"))
    c("read_mean", str(tmp / f"{tag}.binaryproto"))
    key = c("get_init_key")
    c("reset")
    assert c("get_init_key") != key
    return out, (deploy, train, solver)


@pytest.fixture()
def files(tmp_path):
    (tmp_path / "deploy.prototxt").write_text(DEPLOY)
    (tmp_path / "train.prototxt").write_text(TRAIN)
    (tmp_path / "solver.prototxt").write_text(
        SOLVER % (tmp_path / "train.prototxt"))
    return tmp_path


def test_command_stream_equals_jax(files):
    want, _ = _stream(JM.MatBridge(seed=7), files, "jax")
    got, _ = _stream(TM.MatBridge(seed=7, device="cpu"), files, "torch")
    assert [c for c, _ in got] == [c for c, _ in want]
    for i, ((cmd, g), (_, w)) in enumerate(zip(got, want)):
        _same(g, w, f"{i}:{cmd}")
    assert (files / "torch.caffemodel").read_bytes() \
        == (files / "jax.caffemodel").read_bytes()
    assert (files / "torch.binaryproto").read_bytes() \
        == (files / "jax.binaryproto").read_bytes()


def test_command_stream_over_the_wire_equals_in_process(files):
    srv, port = TM.serve_matcaffe(
        "127.0.0.1", 0, TM.MatBridge(seed=7, device="cpu"), background=True)
    client = TM.MatClient("127.0.0.1", port)
    try:
        assert client("ping") == "pong"
        wire, _ = _stream(client, files, "wire")
        with pytest.raises(RuntimeError, match="Unknown command"):
            client("no_such_command")
        client("shutdown")
    finally:
        client.close()
        srv.shutdown()
        srv.server_close()
    local, _ = _stream(TM.MatBridge(seed=7, device="cpu"), files, "local")
    for i, ((cmd, g), (_, w)) in enumerate(zip(wire, local)):
        _same(g, w, f"{i}:{cmd}")


def test_stale_handles_and_errors_equal_jax(files):
    for bridge in (JM.MatBridge(seed=3), TM.MatBridge(seed=3, device="cpu")):
        h = bridge("get_net", str(files / "deploy.prototxt"), "test")
        bridge("reset")
        with pytest.raises(ValueError, match="invalid init_key"):
            bridge("net_get_attr", h)
        with pytest.raises(ValueError, match="Unknown phase"):
            bridge("get_net", str(files / "deploy.prototxt"), "val")
        with pytest.raises(ValueError, match="Unknown command"):
            bridge("frobnicate")


def test_forward_keeps_blobs_on_the_device_and_copies_one_a_read(
        files, monkeypatch):
    """After ``net_forward`` the activations stay tensors where the net
    made them; shape queries copy nothing, and ``blob_get_data`` copies
    the one blob it reads."""
    import torch

    bridge = TM.MatBridge(seed=7, device="cpu")
    h = bridge("get_net", str(files / "deploy.prototxt"), "test")
    attr = bridge("net_get_attr", h)
    bridge("net_forward", h)
    copied = []
    value = TM._MatNet._blob_value
    monkeypatch.setattr(TM._MatNet, "_blob_value", lambda self, name: (
        copied.append(name), value(self, name))[1])
    for bh in attr["hBlob_blobs"]:
        bridge("blob_get_shape", bh)
    assert copied == []
    prob = attr["blob_names"].index("prob")
    got = bridge("blob_get_data", attr["hBlob_blobs"][prob])
    assert copied == ["prob"] and got.shape == (5, 3)
    net = next(o for o in bridge._objects.values()
               if isinstance(o, TM._MatNet))
    assert set(net._tensors) == set(attr["blob_names"])
    assert all(torch.is_tensor(t) for t in net._tensors.values())


def test_layout_helpers_equal_jax():
    a = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(TM.to_mat(a), JM.to_mat(a))
    np.testing.assert_array_equal(TM.from_mat(TM.to_mat(a)), a)
    np.testing.assert_array_equal(TM._nhwc_to_caffe(a), JM._nhwc_to_caffe(a))
    np.testing.assert_array_equal(TM._caffe_to_nhwc(a), JM._caffe_to_nhwc(a))
    enc = TM.encode_value({"m": TM.to_mat(a), "n": [np.float32(2.0)]})
    assert enc == JM.encode_value({"m": JM.to_mat(a),
                                   "n": [np.float32(2.0)]})
    np.testing.assert_array_equal(TM.decode_value(enc)["m"], TM.to_mat(a))


# -- the static check of tests/test_matlab_client.py, on the port's bridge --

_CALL = re.compile(r"caffe_\(\s*'([a-z_]+)'")
CLIENT_LOCAL = {"connect"}


def _client_commands():
    cmds = set()
    for m_file in sorted((ROOT / "matlab").rglob("*.m")):
        cmds |= set(_CALL.findall(m_file.read_text()))
    return cmds


def _bridge_commands(cls):
    return {n[len("cmd_"):] for n in dir(cls) if n.startswith("cmd_")}


def test_every_client_command_has_a_port_handler():
    assert not _client_commands() - CLIENT_LOCAL - _bridge_commands(
        TM.MatBridge)


def test_every_port_command_is_reachable_from_the_client():
    assert not _bridge_commands(TM.MatBridge) - _client_commands()


def test_port_surface_equals_the_reference_mex():
    assert _bridge_commands(TM.MatBridge) == _bridge_commands(JM.MatBridge)
    assert len(_bridge_commands(TM.MatBridge)) == 29
