"""``caffe.io`` (``utils/io.py``), the WindowData feed
(``data/window_data.py``), ``Classifier`` / ``Detector``
(``models/classifier.py``, ``models/detector.py``) and ``draw``
(``utils/draw.py``) of the port against the JAX package's, on CPU.

Tolerances: the BlobProto / Datum bytes and the DOT text exactly;
``Transformer``, ``oversample``, ``resize_image`` and the window crops
within 1e-5 (the same numpy and scipy code: they come out equal); the
classifier's and detector's probabilities within 1e-5, on one
``.caffemodel`` the JAX net wrote (float32 sums in another order).
"""

import numpy as np
import pytest

from mms_answer_selection_tpu.data import window_data as jwd
from mms_answer_selection_tpu.models.classifier import Classifier as JClf
from mms_answer_selection_tpu.models.detector import Detector as JDet
from mms_answer_selection_tpu.utils import draw as jdraw
from mms_answer_selection_tpu.utils import io as jio
from mms_answer_selection_tpu_torch.data import window_data as twd
from mms_answer_selection_tpu_torch.models.classifier import \
    Classifier as TClf
from mms_answer_selection_tpu_torch.models.detector import Detector as TDet
from mms_answer_selection_tpu_torch.utils import draw as tdraw
from mms_answer_selection_tpu_torch.utils import io as tio
from mms_answer_selection_tpu_torch.utils.prototxt import \
    net_prototxt_from_config

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng


# ------------------------------------------------------ blobs and datums

ARRAYS = {
    "f32_4d": RNG(0).normal(size=(2, 3, 4, 5)).astype(np.float32),
    "f32_1d": RNG(1).normal(size=(7,)).astype(np.float32),
    "f64_2d": RNG(2).normal(size=(3, 4)),
    "u8_3d": RNG(3).integers(0, 256, (3, 5, 4)).astype(np.uint8),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_blobproto_bytes_equal_jax(name):
    arr = ARRAYS[name]
    want = jio.array_to_blobproto(arr, diff=arr * 2)
    assert tio.array_to_blobproto(arr, diff=arr * 2) == want
    for rd in (False, True):
        got = tio.blobproto_to_array(want, return_diff=rd)
        np.testing.assert_array_equal(got, jio.blobproto_to_array(
            want, return_diff=rd))
    vec = jio.arraylist_to_blobprotovector_str([arr, arr[:1]])
    assert tio.arraylist_to_blobprotovector_str([arr, arr[:1]]) == vec
    for a, b in zip(tio.blobprotovector_str_to_arraylist(vec),
                    jio.blobprotovector_str_to_arraylist(vec)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["u8_3d", "f32_3d"])
@pytest.mark.parametrize("label", [0, 5, -3, None])
def test_datum_bytes_equal_jax(name, label):
    arr = ARRAYS["u8_3d"] if name == "u8_3d" else \
        RNG(4).normal(size=(2, 3, 4)).astype(np.float32)
    want = jio.array_to_datum(arr, label)
    got = tio.array_to_datum(arr, label)
    assert bytes(got) == bytes(want)
    assert got.SerializeToString() == want.SerializeToString()
    np.testing.assert_array_equal(tio.datum_to_array(want),
                                  jio.datum_to_array(want))
    assert tio.datum_label(want) == jio.datum_label(want)


def test_io_refuses_what_jax_refuses():
    for io in (jio, tio):
        with pytest.raises(ValueError):
            io.array_to_datum(np.zeros((2, 2)))
        with pytest.raises(ValueError):
            io.blobproto_to_array(io.array_to_blobproto(np.zeros(3)),
                                  return_diff=True)


# ------------------------------------------------------------ Transformer

def _transformer(io, shape, opts):
    tf = io.Transformer({"data": shape})
    tf.set_transpose("data", (2, 0, 1))
    if "swap" in opts:
        tf.set_channel_swap("data", (2, 1, 0))
    if "raw" in opts:
        tf.set_raw_scale("data", 255.0)
    if "mean" in opts:
        tf.set_mean("data", np.array([10.0, 20.0, 30.0]))
    if "full_mean" in opts:
        tf.set_mean("data", RNG(5).random(shape[1:]) * 50)
    if "scale" in opts:
        tf.set_input_scale("data", 0.5)
    return tf


@pytest.mark.parametrize("opts", [(), ("swap",), ("swap", "raw"),
                                  ("swap", "raw", "mean", "scale"),
                                  ("full_mean", "scale")])
@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_transformer_equals_jax(opts, hw):
    shape = (1, 3, 8, 8)
    im = RNG(6).random(hw + (3,)).astype(np.float32)
    j, t = _transformer(jio, shape, opts), _transformer(tio, shape, opts)
    x = j.preprocess("data", im)
    np.testing.assert_allclose(t.preprocess("data", im), x, **TOL)
    np.testing.assert_allclose(t.deprocess("data", x),
                               j.deprocess("data", x), **TOL)


@pytest.mark.parametrize("shape", [(10, 11, 3), (7, 5, 1), (6, 6, 4),
                                   (9, 9, 3)])
@pytest.mark.parametrize("new", [(12, 12), (4, 6), (9, 9)])
def test_resize_image_equals_jax(shape, new):
    im = RNG(7).random(shape).astype(np.float32)
    for order in (0, 1):
        np.testing.assert_allclose(tio.resize_image(im, new, order),
                                   jio.resize_image(im, new, order), **TOL)


@pytest.mark.parametrize("crop", [(4, 4), (5, 3), (8, 8)])
def test_oversample_equals_jax(crop):
    ims = RNG(8).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tio.oversample(ims, crop),
                               jio.oversample(ims, crop), **TOL)


@pytest.mark.parametrize("kind", ["f32", "u8_gray", "u8_rgb"])
def test_load_image_npy_equals_jax(tmp_path, kind):
    rng = RNG(9)
    arr = {"f32": rng.random((5, 6, 3)).astype(np.float32),
           "u8_gray": rng.integers(0, 256, (5, 6)).astype(np.uint8),
           "u8_rgb": rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)}[kind]
    np.save(tmp_path / "im.npy", arr)
    for color in (True, False):
        np.testing.assert_array_equal(
            tio.load_image(str(tmp_path / "im.npy"), color),
            jio.load_image(str(tmp_path / "im.npy"), color))


# -------------------------------------------------------------- WindowData

def _window_corpus(tmp_path, n_images=4, size=16):
    rng = RNG(10)
    lines = []
    for i in range(n_images):
        np.save(tmp_path / f"im{i}.npy",
                rng.integers(0, 256, (size, size, 3)).astype(np.float32))
        lines += [f"# {i}", str(tmp_path / f"im{i}.npy"), "3", str(size),
                  str(size), "4", "1 0.8 0 0 7 7", "2 0.7 2 2 13 9",
                  "2 0.55 1 1 6 6", "3 0.1 4 4 15 15"]
    (tmp_path / "windows.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "windows.txt")


def test_parse_window_file_equals_jax(tmp_path):
    src = _window_corpus(tmp_path)
    for th in ((0.5, 0.5), (0.6, 0.3)):
        assert twd.parse_window_file(src, fg_threshold=th[0],
                                     bg_threshold=th[1]) == \
            jwd.parse_window_file(src, fg_threshold=th[0],
                                  bg_threshold=th[1])


WINDOW_OPTS = {
    "warp": dict(crop_size=8),
    "square": dict(crop_size=8, crop_mode="square"),
    "context": dict(crop_size=10, context_pad=2),
    "mirror": dict(crop_size=8, mirror=True),
    "mean": dict(crop_size=8, mean=[5.0, 10.0, 15.0], scale=0.5),
    "full_mean": dict(crop_size=8, context_pad=1,
                      mean=RNG(11).random((12, 12, 3)) * 40),
    "fg_half": dict(crop_size=6, fg_fraction=0.5, cache_images=True),
}


@pytest.mark.parametrize("opts", sorted(WINDOW_OPTS))
def test_window_batches_equal_jax(tmp_path, opts):
    src = _window_corpus(tmp_path)
    kw = dict(WINDOW_OPTS[opts], seed=3)
    j = jwd.WindowListDataset(src, 8, **kw)
    t = twd.WindowListDataset(src, 8, **kw)
    for _ in range(4):
        jb, tb = next(iter(j)), next(iter(t))
        np.testing.assert_allclose(tb["data"], jb["data"], **TOL)
        np.testing.assert_array_equal(tb["label"], jb["label"])


def test_window_data_layer_under_graph_solver_equals_jax(tmp_path):
    from mms_answer_selection_tpu.training.graph_solver import \
        GraphSolver as JGS
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver as TGS

    src = _window_corpus(tmp_path)
    (tmp_path / "net.prototxt").write_text(f"""
layer {{ name: "w" type: "WindowData" top: "data" top: "label"
  window_data_param {{ source: "{src}" batch_size: 8 fg_threshold: 0.5
    bg_threshold: 0.5 fg_fraction: 0.25 context_pad: 1 scale: 0.0039 }}
  transform_param {{ crop_size: 8 mean_value: 100 mean_value: 110
    mean_value: 120 }} }}
layer {{ name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
  inner_product_param {{ num_output: 4 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "fc" bottom: "label"
  top: "loss" }}
""")
    (tmp_path / "solver.prototxt").write_text(
        'net: "net.prototxt"\nbase_lr: 0.01\ntype: "SGD"\nmax_iter: 2\n'
        'snapshot_after_train: false\nrandom_seed: 4\n')
    sp = str(tmp_path / "solver.prototxt")
    jgs, tgs = JGS(sp), TGS(sp, device="cpu")
    for _ in range(4):
        jb, tb = jgs._next_batch(jgs._feeds), tgs._next_batch(tgs._feeds)
        for k in jb:
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       **TOL)
    tgs.step(2)
    assert tgs.iter_ == 2 and np.isfinite(tgs._smoothed)


# ------------------------------------------------- Classifier / Detector

DEPLOY = """
name: "tinyclf"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "flat" type: "Flatten" bottom: "conv" top: "flat" }
layer { name: "fc" type: "InnerProduct" bottom: "flat" top: "fc"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""


@pytest.fixture
def deploy(tmp_path):
    """The deploy net and the weights a JAX Classifier initialised."""
    (tmp_path / "deploy.prototxt").write_text(DEPLOY)
    j = JClf(str(tmp_path / "deploy.prototxt"))
    j.predict([RNG(12).random((8, 8, 3)).astype(np.float32)],
              oversample=False)
    j.save(str(tmp_path / "w.caffemodel"))
    return str(tmp_path / "deploy.prototxt"), str(tmp_path / "w.caffemodel")


CLF_OPTS = {
    "default": dict(),
    "mean_swap": dict(image_dims=(12, 12), mean=np.array([0.1, 0.2, 0.3]),
                      raw_scale=1.0, channel_swap=(2, 1, 0)),
    "full": dict(image_dims=(10, 10), mean=RNG(13).random((3, 8, 8)),
                 raw_scale=255.0, input_scale=0.01, channel_swap=(2, 1, 0)),
}


@pytest.mark.parametrize("opts", sorted(CLF_OPTS))
@pytest.mark.parametrize("oversample", [True, False])
def test_classifier_predict_equals_jax(deploy, opts, oversample):
    model, weights = deploy
    ims = [RNG(14).random((10, 11, 3)).astype(np.float32) for _ in range(3)]
    j = JClf(model, weights, **CLF_OPTS[opts])
    t = TClf(model, weights, device="cpu", **CLF_OPTS[opts])
    np.testing.assert_allclose(t.predict(ims, oversample),
                               j.predict(ims, oversample), **TOL)


def test_classifier_refuses_what_jax_refuses(tmp_path):
    (tmp_path / "d.prototxt").write_text(
        'layer { name: "in" type: "Input" top: "data" }\n'
        'layer { name: "r" type: "ReLU" bottom: "data" top: "y" }\n')
    for make in (lambda p: JClf(p), lambda p: TClf(p, device="cpu")):
        with pytest.raises(ValueError, match="declare"):
            make(str(tmp_path / "d.prototxt"))


DET_OPTS = {
    "plain": dict(),
    "context": dict(context_pad=2, mean=np.array([0.5, 0.5, 0.5])),
    "context_full": dict(context_pad=1, mean=RNG(15).random((3, 8, 8)),
                         raw_scale=255.0, channel_swap=(2, 1, 0)),
}


@pytest.mark.parametrize("opts", sorted(DET_OPTS))
def test_detector_equals_jax(tmp_path, deploy, opts):
    model, weights = deploy
    im = RNG(16).random((20, 18, 3)).astype(np.float32)
    np.save(tmp_path / "im.npy", im)
    windows = [np.array(w) for w in ([0, 0, 8, 8], [4, 4, 16, 16],
                                     [1, 10, 19, 17], [0, 0, 20, 18])]
    j = JDet(model, weights, **DET_OPTS[opts])
    t = TDet(model, weights, device="cpu", **DET_OPTS[opts])
    for w in windows:
        np.testing.assert_allclose(t.crop(im, w), j.crop(im, w), **TOL)
    jd = j.detect_windows([(str(tmp_path / "im.npy"), windows)])
    td = t.detect_windows([(str(tmp_path / "im.npy"), windows)])
    assert [d["filename"] for d in td] == [d["filename"] for d in jd]
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a["window"], b["window"])
        np.testing.assert_allclose(a["prediction"], b["prediction"], **TOL)


# ------------------------------------------------------------------ draw

def _v4_text():
    import dataclasses

    from mms_answer_selection_tpu_torch.models.mms_qa import V4

    return net_prototxt_from_config(dataclasses.replace(V4, vocab_size=50),
                                    phase="eval")


@pytest.mark.parametrize("net", ["v4", "deploy"])
@pytest.mark.parametrize("phase", [None, "train", "test"])
@pytest.mark.parametrize("rankdir", ["LR", "TB"])
def test_draw_dot_equals_jax(net, phase, rankdir):
    text = _v4_text() if net == "v4" else DEPLOY
    want = jdraw.net_to_dot(text, phase=phase, rankdir=rankdir)
    assert tdraw.net_to_dot(text, phase=phase, rankdir=rankdir) == want
