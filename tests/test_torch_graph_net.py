"""GraphNet in the port against the JAX package's GraphNet, on CPU.

Each net is built from the same prototxt in both packages; the JAX net is
initialised by ``jax.random`` and its params and state are carried into
the port by ``convert.params_from_numpy`` (the port's own init must give
the same tree: keys, shapes).  Both then run the same seeded numpy inputs
and are compared on:

* every blob the forward makes, and the new state: within 1e-5 of each
  array's largest |value| (float32; convolutions, BN means and the pair
  maps sum in other orders); integer blobs exactly;
* the weighted loss sum: rtol 1e-5;
* the gradient of an objective, the loss plus the sum of every float
  output blob times a fixed random cotangent, with respect to every
  parameter and every float input: within 1e-4 of each leaf's largest
  |value| (the chain of layers compounds the float32 differences).  Where
  a train-mode BN follows a convolution the conv bias's true gradient is
  0 (BN subtracts the batch mean) and each package computes rounding
  noise: those biases are held to that, each package's value within 5%
  of its weight's largest gradient, and are not compared with each other.

The random layers (Dropout, STOCHASTIC pooling, random DummyData) draw
from each package's own generator, so the nets here turn them off (ratio
0, TEST phase, constant fillers) and ``test_random_layers_*`` holds the
port's draws statistically.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import graph_net as JGN
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.utils.prototxt import net_prototxt_from_config
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import graph_net as TGN
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent
FWD_RTOL, LOSS_RTOL, GRAD_RTOL, NOISE_FRAC = 1e-5, 1e-5, 1e-4, 0.05


def _close(got, want, what, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    got, want = np.where(inf, 0, got), np.where(inf, 0, want)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} x {scale:.3e}"


def _shapes(tree):
    return {k: ({kk: tuple(np.shape(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else tuple(np.shape(v)))
            for k, v in tree.items()}


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def run_both(txt, inputs, *, phase="train", train=False, seed=0,
             tweak=None, noise=(), jax_rng=None):
    """Build, carry the JAX init over, run forward and gradients in both
    packages and compare.  ``tweak(params, state)`` edits the numpy trees
    before both runs; ``noise`` names the (layer, key) params whose
    gradient is rounding noise.  Returns (port blobs, JAX blobs)."""
    jnet = JGN.GraphNet(txt, phase=phase)
    tnet = TGN.GraphNet(txt, phase=phase)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jp, js = jax.device_get(jnet.init(jax.random.PRNGKey(seed), jin))
    jp = jax.tree.map(np.array, jp)
    js = jax.tree.map(np.array, js)
    tp0, ts0 = tnet.init(torch.Generator().manual_seed(seed), inputs,
                         device="cpu")
    assert _shapes(tp0) == _shapes(jp) and _shapes(ts0) == _shapes(js)
    if tweak is not None:
        tweak(jp, js)
    tp, ts = params_from_numpy(jp, js, "cpu")

    jblobs, _ = jnet.apply(jp, js, jin, train=train, rng=jax_rng)
    rng = np.random.default_rng(seed + 1)
    cots = {n: rng.normal(size=np.shape(jblobs[n])).astype(np.float32)
            for n in jnet.output_blob_names()
            if _is_float(jblobs[n]) and np.size(jblobs[n])
            and np.isfinite(np.asarray(jblobs[n])).all()}
    fin = sorted(k for k, v in inputs.items() if _is_float(v))

    def j_obj(p, xs):
        ins = {**jin, **dict(zip(fin, xs))}
        total, (blobs, ns) = jnet.loss(p, js, ins, train=train, rng=jax_rng)
        obj = total + sum(jnp.sum(blobs[n].astype(jnp.float32) * c)
                          for n, c in cots.items())
        return obj, (total, blobs, ns)

    (_, (j_total, jblobs, jns)), (jgp, jgx) = jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True)(
            jp, [jin[k] for k in fin])

    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    xs = {k: torch.tensor(inputs[k], requires_grad=True) for k in fin}
    t_total, (tblobs, tns) = tnet.loss(tp, ts, {**inputs, **xs},
                                       train=train)
    obj = t_total + sum(torch.sum(tblobs[n].float() * torch.as_tensor(c))
                        for n, c in cots.items())
    grads = torch.autograd.grad(obj, leaves + [xs[k] for k in fin],
                                allow_unused=True)

    _close(float(t_total.detach()), float(j_total), "loss", LOSS_RTOL)
    for name, want in jblobs.items():
        _close(tblobs[name].detach().numpy(), want, f"blob {name}",
               FWD_RTOL)
    for ln, sub in jns.items():
        for k, want in sub.items():
            _close(tns[ln][k].detach().numpy(), want, f"state {ln}/{k}",
                   FWD_RTOL)
    it = iter(grads)
    tg = tree_map(lambda _: next(it), tp)
    for ln, sub in jgp.items():
        for k, want in sub.items():
            got = tg[ln][k]
            got = np.zeros_like(want) if got is None else got.numpy()
            if (ln, k) in noise:
                scale = float(np.abs(jgp[ln]["w"]).max())
                for g in (got, np.asarray(want)):
                    assert np.abs(g).max() <= NOISE_FRAC * scale, (ln, k)
            else:
                _close(got, want, f"grad {ln}/{k}", GRAD_RTOL)
    for k, want in zip(fin, jgx):
        got = next(it)
        got = np.zeros_like(want) if got is None else got.numpy()
        _close(got, want, f"grad of input {k}", GRAD_RTOL)
    return tblobs, jblobs


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------- the V4 net

def _qa_batch(rng, n=6, vocab=120):
    return {"question": rng.integers(0, vocab, (n, 40)).astype(np.int32),
            "answer": rng.integers(0, vocab, (n, 40)).astype(np.int32),
            "label": rng.integers(0, 2, (n,)).astype(np.int32),
            "group": np.repeat(np.arange(n // 3), 3)[:n].astype(np.int32),
            "overlap_feat": rng.normal(size=(n, 2)).astype(np.float32)}


def _xavier_w(params, state):
    """The recipe initialises W at 0, where the sim map is constant and
    train-mode BN divides by sqrt(1e-9); a xavier-sized W keeps the
    comparison well conditioned."""
    w = params["sim_cross"]["w"]
    params["sim_cross"]["w"] = np.random.default_rng(5).uniform(
        -0.035, 0.035, w.shape).astype(np.float32)


def _trained_stats(params, state):
    """Eval-mode BN reads the running stats; from their init (var 0) it
    would divide by sqrt(1e-9), so give them trained-looking values."""
    _xavier_w(params, state)
    rng = np.random.default_rng(6)
    for bn in state.values():
        bn["mean"] = rng.normal(size=bn["mean"].shape).astype(
            np.float32) * 0.01
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
            np.float32) * 1e-3


V4_CFG = dataclasses.replace(JQ.V4, vocab_size=120, sim_dropout=0.0,
                             fc1_dropout=0.0)


def test_v4_recipe_train_net_matches():
    """The recipe's train net from ``net_prototxt_from_config`` (V4's
    widths, a small vocabulary, dropout 0): forward, loss and the gradient
    of every parameter, BN in train mode."""
    run_both(net_prototxt_from_config(V4_CFG), _qa_batch(
        np.random.default_rng(1)), train=True, seed=3, tweak=_xavier_w,
        noise={("conv0", "b"), ("conv1", "b")})


def test_v4_recipe_eval_net_matches():
    """The eval net (TEST phase: MAP, MRR, AUC layers) in eval mode: every
    gradient is well defined there, the conv biases' too."""
    tb, jb = run_both(net_prototxt_from_config(V4_CFG, phase="eval"),
                      _qa_batch(np.random.default_rng(2), n=9),
                      phase="test", seed=4, tweak=_trained_stats)
    for k in ("map", "mrr", "auc", "prob", "loss"):
        assert k in tb and k in jb


def test_v4_recipe_net_at_zero_w_blocks_embed_grads():
    """At the recipe's W = 0 the embedding gradient is exactly 0 in the
    port too (the reference's constant-filler quirk)."""
    net = TGN.GraphNet(net_prototxt_from_config(V4_CFG), phase="train")
    batch = _qa_batch(np.random.default_rng(1))
    params, state = net.init(torch.Generator().manual_seed(0), batch,
                             device="cpu")
    assert not params["sim_cross"]["w"].any()
    assert "w2v_a" not in params      # one owner of the shared embedding
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    total, _ = net.loss(params, state, batch)
    total.backward()
    assert params["fc2"]["w"].grad.abs().sum() > 0
    assert not params["w2v_q"]["w"].grad.any()
    assert all(t.grad is not None for t in leaves)


# ------------------------------------------------------ generic_mlp, legacy

@pytest.mark.parametrize("phase", ["train", "test"])
def test_generic_mlp_example_net_matches(phase):
    rng = np.random.default_rng(0)
    ins = {"data": rng.normal(size=(16, 6)).astype(np.float32),
           "label": rng.integers(0, 3, (16,)).astype(np.float32)}
    run_both((ROOT / "examples" / "generic_mlp" / "net.prototxt")
             .read_text(), ins, phase=phase, train=phase == "train")


def test_legacy_v1_net_matches():
    rng = np.random.default_rng(0)
    ins = {"data": rng.normal(size=(8, 6)).astype(np.float32),
           "label": rng.integers(0, 8, (8,)).astype(np.int32)}
    run_both((ROOT / "examples" / "generic_mlp" / "legacy_v1.prototxt")
             .read_text(), ins, train=True)


# ------------------------------------------------------------- inline nets

NEURON_CHAIN = """
layer { name: "d" type: "Input" top: "x" }
layer { name: "p" type: "Power" bottom: "x" top: "p"
  power_param { power: 2 scale: 3 shift: 1 } }
layer { name: "e" type: "Exp" bottom: "x" top: "e" exp_param { base: 2 } }
layer { name: "l" type: "Log" bottom: "e" top: "l" log_param { base: 2 } }
layer { name: "t" type: "Threshold" bottom: "x" top: "t"
  threshold_param { threshold: 0.5 } }
layer { name: "a" type: "AbsVal" bottom: "x" top: "a" }
layer { name: "bn" type: "BNLL" bottom: "x" top: "bn" }
layer { name: "el" type: "ELU" bottom: "x" top: "el"
  elu_param { alpha: 0.5 } }
layer { name: "re" type: "ReLU" bottom: "x" top: "re"
  relu_param { negative_slope: 0.1 } }
layer { name: "sg" type: "Sigmoid" bottom: "x" top: "sg" }
layer { name: "th" type: "TanH" bottom: "x" top: "th" }
layer { name: "pr" type: "PReLU" bottom: "x" top: "pr"
  prelu_param { filler { type: "gaussian" std: 0.3 } } }
"""

STRUCTURAL = """
layer { name: "d" type: "Input" top: "x" }
layer { name: "sl" type: "Slice" bottom: "x" top: "s1" top: "s2"
  slice_param { axis: 1 slice_point: 2 } }
layer { name: "cc" type: "Concat" bottom: "s2" bottom: "s1"
  top: "cat" concat_param { axis: 1 } }
layer { name: "sp" type: "Split" bottom: "cat" top: "c1" top: "c2" }
layer { name: "ew" type: "Eltwise" bottom: "c1" bottom: "c2"
  top: "ew" eltwise_param { operation: SUM coeff: 1 coeff: -0.5 } }
layer { name: "mx" type: "Eltwise" bottom: "c1" bottom: "ew"
  top: "mx" eltwise_param { operation: MAX } }
layer { name: "ti" type: "Tile" bottom: "x" top: "ti"
  tile_param { axis: 0 tiles: 2 } }
layer { name: "fl" type: "Flatten" bottom: "x" top: "fl" }
layer { name: "rs" type: "Reshape" bottom: "x" top: "rs"
  reshape_param { shape { dim: 0 dim: -1 dim: 2 } } }
layer { name: "sm" type: "Softmax" bottom: "rs" top: "smx"
  softmax_param { axis: 2 } }
layer { name: "rd" type: "Reduction" bottom: "x" top: "rd"
  reduction_param { operation: SUMSQ axis: 1 coeff: 0.5 } }
"""

VISION = """
layer { name: "d" type: "Input" top: "x" }
layer { name: "cv" type: "Convolution" bottom: "x" top: "cv"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 stride: 1
    weight_filler { type: "msra" } bias_filler { type: "constant"
    value: 0.5 } } }
layer { name: "po" type: "Pooling" bottom: "cv" top: "po"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "pa" type: "Pooling" bottom: "cv" top: "pa"
  pooling_param { pool: AVE kernel_size: 3 stride: 2 pad: 1 } }
layer { name: "gp" type: "Pooling" bottom: "cv" top: "gp"
  pooling_param { pool: AVE global_pooling: true } }
layer { name: "lr" type: "LRN" bottom: "cv" top: "lr"
  lrn_param { local_size: 3 alpha: 2 beta: 0.5 } }
layer { name: "lw" type: "LRN" bottom: "cv" top: "lw"
  lrn_param { local_size: 3 norm_region: WITHIN_CHANNEL } }
layer { name: "mv" type: "MVN" bottom: "cv" top: "mv" }
layer { name: "dc" type: "Deconvolution" bottom: "po" top: "dc"
  convolution_param { num_output: 2 kernel_size: 2 stride: 2
    weight_filler { type: "bilinear" } bias_term: false } }
layer { name: "sc" type: "Scale" bottom: "cv" top: "sc"
  scale_param { bias_term: true filler { type: "gaussian" std: 1 }
    bias_filler { type: "gaussian" std: 1 } } }
layer { name: "bi" type: "Bias" bottom: "cv" top: "bi"
  bias_param { filler { type: "gaussian" std: 1 } } }
layer { name: "cr" type: "Crop" bottom: "cv" bottom: "po" top: "cr"
  crop_param { axis: 2 offset: 1 } }
layer { name: "spp" type: "SPP" bottom: "cv" top: "spp"
  spp_param { pyramid_height: 2 } }
layer { name: "sq" type: "Pooling" bottom: "po" top: "sq"
  pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
layer { name: "i2c" type: "Im2col" bottom: "x" top: "i2c"
  convolution_param { kernel_size: 2 stride: 2 } }
layer { name: "am" type: "ArgMax" bottom: "cv" top: "am"
  argmax_param { top_k: 2 } }
"""

GROUPED_CONV = """
layer { name: "d" type: "Input" top: "x" }
layer { name: "cv" type: "Convolution" bottom: "x" top: "cv"
  convolution_param { num_output: 4 kernel_size: 3 group: 2
    dilation: 2 weight_filler { type: "gaussian" std: 1 } } }
layer { name: "c2" type: "Convolution" bottom: "cv" top: "c2"
  convolution_param { num_output: 6 kernel_h: 2 kernel_w: 3 stride: 2
    pad_h: 1 pad_w: 0 weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "dg" type: "Deconvolution" bottom: "c2" top: "dg"
  convolution_param { num_output: 4 kernel_size: 3 stride: 2 pad: 1
    group: 2 weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "gaussian" std: 0.1 } } }
"""

RECURRENT_SIMILARITY = """
layer { name: "d" type: "Input" top: "x" top: "cont" top: "q" top: "a"
  top: "u" top: "v" }
layer { name: "ls" type: "LSTM" bottom: "x" bottom: "cont" top: "ls"
  recurrent_param { num_output: 5
    weight_filler { type: "uniform" min: -0.3 max: 0.3 }
    bias_filler { type: "uniform" min: -0.1 max: 0.1 } } }
layer { name: "rn" type: "RNN" bottom: "x" bottom: "cont" top: "rn"
  recurrent_param { num_output: 5
    weight_filler { type: "uniform" min: -0.3 max: 0.3 }
    bias_filler { type: "uniform" min: -0.1 max: 0.1 } } }
layer { name: "s0" type: "SimCross" bottom: "q" bottom: "a" top: "s0"
  sim_cross_param { dist_mode: 0 } }
layer { name: "s1" type: "SimCross" bottom: "q" bottom: "a" top: "s1"
  sim_cross_param { dist_mode: 1 } }
layer { name: "s2" type: "SimCross" bottom: "q" bottom: "a" top: "s2"
  sim_cross_param { dist_mode: 2 mesure_count: 3
    weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "sm" type: "SimMatrix" bottom: "u" bottom: "v"
  top: "sm" sim_matrix_param {
    weight_filler { type: "gaussian" std: 0.2 } } }
layer { name: "fm" type: "FM" bottom: "q" top: "fm" }
"""

LOSSES_AND_METRICS = """
layer { name: "d" type: "Input" top: "x" top: "lab" top: "pa"
  top: "pb" top: "py" top: "H" top: "grp" }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "lg"
  inner_product_param { num_output: 2
    weight_filler { type: "gaussian" std: 0.5 } } }
layer { name: "sm" type: "Softmax" bottom: "lg" top: "prob" }
layer { name: "l1" type: "SoftmaxWithLoss" bottom: "lg"
  bottom: "lab" top: "l1" }
layer { name: "l2" type: "HingeLoss" bottom: "lg" bottom: "lab"
  top: "l2" hinge_loss_param { norm: L2 } }
layer { name: "l3" type: "SigmoidCrossEntropyLoss" bottom: "pa"
  bottom: "py" top: "l3" }
layer { name: "l4" type: "EuclideanLoss" bottom: "pa" bottom: "pb"
  top: "l4" loss_weight: 0.5 }
layer { name: "l5" type: "ContrastiveLoss" bottom: "pa"
  bottom: "pb" bottom: "lab" top: "l5"
  contrastive_loss_param { margin: 2 } }
layer { name: "l6" type: "MultinomialLogisticLoss" bottom: "prob"
  bottom: "lab" top: "l6" }
layer { name: "l7" type: "InfogainLoss" bottom: "prob"
  bottom: "lab" bottom: "H" top: "l7" }
layer { name: "l8" type: "PairRankLoss" bottom: "pa" bottom: "pb"
  bottom: "lab" top: "l8" pair_rank_loss_param { margin: 0.5 } }
layer { name: "l9" type: "SoftmaxWithLoss" bottom: "lg" bottom: "lab"
  top: "l9" loss_param { ignore_label: 1 } loss_weight: 2 }
layer { name: "ac" type: "Accuracy" bottom: "lg" bottom: "lab"
  top: "ac" }
layer { name: "am" type: "ArgMax" bottom: "lg" top: "am" }
layer { name: "ra" type: "RankAccuracy" bottom: "pa" bottom: "pb"
  bottom: "lab" top: "ra" }
layer { name: "mrr" type: "MRR" bottom: "prob" bottom: "lab"
  bottom: "grp" top: "mrr" }
layer { name: "map" type: "MAP" bottom: "prob" bottom: "lab"
  bottom: "grp" top: "map" }
layer { name: "auc" type: "AUC" bottom: "prob" bottom: "lab" top: "auc" }
"""

FILTER_REINDEX = """
layer { name: "d" type: "Input" top: "x" top: "sel" top: "perm" }
layer { name: "f" type: "Filter" bottom: "x" bottom: "sel" top: "fx"
  top: "count" }
layer { name: "br" type: "BatchReindex" bottom: "x" bottom: "perm"
  top: "bx" }
"""

DUMMY_PARAMETER = """
layer { name: "dd" type: "DummyData" top: "c" top: "c2"
  dummy_data_param { shape { dim: 2 dim: 3 }
    data_filler { type: "constant" value: 4 } } }
layer { name: "d4" type: "DummyData" top: "img"
  dummy_data_param { shape { dim: 2 dim: 3 dim: 4 dim: 5 }
    data_filler { type: "constant" value: 1 } } }
layer { name: "pp" type: "Parameter" top: "w"
  parameter_param { shape { dim: 3 } } }
layer { name: "sc" type: "Scale" bottom: "c" bottom: "w" top: "out" }
layer { name: "si" type: "Silence" bottom: "c2" }
"""

BATCHNORM = """
layer { name: "d" type: "Input" top: "x" }
layer { name: "bn" type: "BatchNorm" bottom: "x" top: "bn"
  batch_norm_param { moving_average_fraction: 0.9 } }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
  scale_param { bias_term: true filler { type: "gaussian" std: 1 } } }
layer { name: "b2" type: "BN" bottom: "x" top: "b2"
  bn_param { bn_memory: 0.7 shift_filler { type: "constant" value: 0.1 } } }
"""

EMBED = """
layer { name: "d" type: "Input" top: "ids" top: "fids" }
layer { name: "em" type: "Embed" bottom: "ids" top: "em"
  embed_param { num_output: 4 input_dim: 10
    weight_filler { type: "uniform" min: -1 max: 1 }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "ef" type: "Embed" bottom: "fids" top: "ef"
  embed_param { num_output: 3 input_dim: 10 bias_term: false
    weight_filler { type: "gaussian" std: 1 } } }
"""

SHARED = """
layer { name: "d" type: "Input" top: "x" top: "y" top: "s0" }
layer { name: "fa" type: "InnerProduct" bottom: "x" top: "a"
  param { name: "tied-w" lr_mult: 1 } param { name: "tied-b" lr_mult: 2 }
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "fb" type: "InnerProduct" bottom: "y" top: "b"
  param { name: "tied-w" } param { name: "tied-b" }
  inner_product_param { num_output: 4 } }
layer { name: "sum" type: "Eltwise" bottom: "a" bottom: "b" top: "s" }
layer { name: "loss" type: "EuclideanLoss" bottom: "s" bottom: "s0"
  top: "loss" }
layer { name: "r" type: "Reduction" bottom: "s" top: "r"
  loss_weight: 0.5 reduction_param { operation: ASUM } }
"""

LSTM_UNIT = """
layer { name: "c0" type: "Input" top: "c_prev" }
layer { name: "x0" type: "Input" top: "x" }
layer { name: "ct" type: "Input" top: "cont" }
layer { name: "u" type: "LSTMUnit" bottom: "c_prev" bottom: "x"
  bottom: "cont" top: "c" top: "h" }
"""

rng_ = np.random.default_rng


INLINE = {
    "neuron_chain": (NEURON_CHAIN, lambda: {"x": _x(3, 4)}, {}),
    "structural": (STRUCTURAL, lambda: {"x": _x(2, 4, seed=1)}, {}),
    "vision": (VISION, lambda: {"x": _x(2, 8, 8, 3, seed=2)},
               {"phase": "test"}),
    "grouped_dilated_conv": (GROUPED_CONV,
                             lambda: {"x": _x(2, 9, 9, 4, seed=3)}, {}),
    "recurrent_similarity": (RECURRENT_SIMILARITY, lambda: {
        "x": _x(7, 2, 3, seed=4),
        "cont": np.asarray([[0, 0]] + [[1, 1]] * 3 + [[0, 1]] + [[1, 1]] * 2,
                           np.float32),
        "q": _x(2, 4, 3, seed=5), "a": _x(2, 5, 3, seed=6),
        "u": _x(2, 4, seed=7), "v": _x(2, 6, seed=8)}, {}),
    "losses_and_metrics": (LOSSES_AND_METRICS, lambda: {
        "x": _x(6, 3, seed=9),
        "lab": np.asarray([0, 1, 1, 0, 1, 0], np.int32),
        "pa": _x(6, 1, seed=10), "pb": _x(6, 1, seed=11),
        "py": rng_(12).integers(0, 2, (6, 1)).astype(np.float32),
        "H": np.asarray([[1.0, 0.2], [0.1, 0.9]], np.float32),
        "grp": np.asarray([0, 0, 0, 1, 1, 1], np.int32)}, {}),
    "filter_reindex": (FILTER_REINDEX, lambda: {
        "x": _x(4, 3, seed=13), "sel": np.asarray([1, 0, 1, 0], np.float32),
        "perm": np.asarray([3, 0, 0], np.int32)}, {}),
    "dummy_parameter": (DUMMY_PARAMETER, lambda: {}, {}),
    "batchnorm_train": (BATCHNORM, lambda: {"x": _x(16, 4, seed=14) * 3 + 2},
                        {"train": True}),
    "embed": (EMBED, lambda: {
        "ids": np.asarray([[1, 2], [3, 9]], np.int32),
        "fids": np.asarray([[0.0, 7.0]], np.float32)}, {}),
    "shared": (SHARED, lambda: {"x": _x(3, 5, seed=15), "y": _x(3, 5, seed=16),
                                "s0": _x(3, 4, seed=17)}, {}),
    "lstm_unit": (LSTM_UNIT, lambda: {
        "c_prev": _x(1, 3, 4, seed=18), "x": _x(1, 3, 16, seed=19),
        "cont": np.asarray([[1.0, 0.0, 1.0]], np.float32)}, {}),
}


@pytest.mark.parametrize("name", sorted(INLINE))
def test_inline_net_matches(name):
    txt, inputs, kw = INLINE[name]
    run_both(txt, inputs(), **kw)


def test_batchnorm_eval_reads_moving_stats():
    def stats(params, state):
        state["bn"]["mean"] = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
        state["bn"]["var"] = np.asarray([2.0, 3.0, 4.0, 5.0], np.float32)
        state["bn"]["factor"] = np.asarray(1.9, np.float32)
        state["b2"]["var"] = np.full((4,), 0.5, np.float32)

    run_both(BATCHNORM, {"x": _x(5, 4, seed=20)}, tweak=stats)


def test_sharing_is_one_tensor_and_param_spec_matches():
    ins = INLINE["shared"][1]()
    j = JGN.GraphNet(SHARED)
    t = TGN.GraphNet(SHARED)
    jp, _ = j.init(jax.random.PRNGKey(0), {k: jnp.asarray(v)
                                           for k, v in ins.items()})
    tp, _ = t.init(torch.Generator(), ins, device="cpu")
    assert sorted(tp) == sorted(jp) == ["fa"]
    assert t.param_spec(tp) == j.param_spec(jp)
    assert t.blob_loss_weights() == j.blob_loss_weights()
    assert t.output_blob_names() == j.output_blob_names()


def test_phase_filter_and_declared_shapes_match():
    txt = """
    input: "data" input_shape { dim: 2 dim: 3 dim: 4 dim: 5 }
    layer { name: "d" type: "Input" top: "x"
      input_param { shape { dim: 6 dim: 7 } } }
    layer { name: "drop" type: "Dropout" bottom: "x" top: "x"
      include { phase: TRAIN } dropout_param { dropout_ratio: 0.4 } }
    layer { name: "s" type: "Sigmoid" bottom: "x" top: "s"
      exclude { phase: TRAIN } }
    layer { name: "acc" type: "Accuracy" bottom: "s" bottom: "lab"
      top: "acc" include { phase: TEST } }
    """
    for phase in ("train", "test"):
        j, t = JGN.GraphNet(txt, phase=phase), TGN.GraphNet(txt, phase=phase)
        assert [n.name for n in t.layers] == [n.name for n in j.layers]
        assert t.input_names == j.input_names
        for nhwc in (True, False):
            assert t.declared_input_shapes(nhwc=nhwc) == \
                j.declared_input_shapes(nhwc=nhwc)
    assert TGN.layer_type_list() == JGN.layer_type_list()
    with pytest.raises(ValueError, match="unknown layer type"):
        TGN.GraphNet('layer { name: "z" type: "Frobnicate" }')
    with pytest.raises(ValueError, match="NetStateRule"):
        TGN.GraphNet('layer { name: "z" type: "ReLU" '
                     'include { stage: "x" } }')


def test_partial_forward_matches():
    ins = INLINE["structural"][1]()
    j, t = JGN.GraphNet(STRUCTURAL), TGN.GraphNet(STRUCTURAL)
    jb, _ = j.apply({}, {}, {k: jnp.asarray(v) for k, v in ins.items()},
                    start="sl", end="cc")
    tb, _ = t.apply({}, {}, {k: torch.as_tensor(v) for k, v in ins.items()},
                    start="sl", end="cc")
    assert sorted(tb) == sorted(jb)
    for k in jb:
        _close(tb[k].numpy(), jb[k], k, FWD_RTOL)


def _scale_plus(x, param_str=None):
    """A Python-layer target both packages can call: tensor or jnp array
    in, the same kind out."""
    return x * float(param_str or 2.0) + 1.0


class _Square:
    def __init__(self, param_str=None):
        self.k = float(param_str or 1.0)

    def forward(self, x):
        return self.k * x * x


def test_python_layer_gets_torch_tensors():
    seen = []

    def spy(x):
        seen.append(type(x))
        return _scale_plus(x, "3")

    globals()["_spy"] = spy
    txt = f"""
    layer {{ name: "d" type: "Input" top: "x" }}
    layer {{ name: "p1" type: "Python" bottom: "x" top: "y"
      python_param {{ module: "{__name__}" layer: "_scale_plus"
        param_str: "3" }} }}
    layer {{ name: "p2" type: "Python" bottom: "y" top: "z"
      python_param {{ module: "{__name__}" layer: "_Square"
        param_str: "0.5" }} }}
    layer {{ name: "p3" type: "Python" bottom: "z" top: "w"
      python_param {{ module: "{__name__}" layer: "_spy" }} }}
    """
    run_both(txt, {"x": _x(3, 2, seed=21)})
    assert torch.Tensor in seen


def test_register_layer_in_both_packages():
    def j_fn(ctx, node, bottoms):
        w = ctx.param(node, "w", lambda k: jnp.full((1,), 3.0))
        return bottoms[0] * w + 1.0

    def t_fn(ctx, node, bottoms):
        w = ctx.param(node, "w", lambda g: torch.full((1,), 3.0,
                                                      device=ctx.device))
        return bottoms[0] * w + 1.0

    name = "ParityScaleShift"
    JGN.register_layer(name, j_fn, param_keys=("w",))
    TGN.register_layer(name, t_fn, param_keys=("w",))
    try:
        with pytest.raises(ValueError, match="already registered"):
            TGN.register_layer(name, t_fn)
        txt = f"""
        layer {{ name: "d" type: "Input" top: "x" }}
        layer {{ name: "ss" type: "{name}" bottom: "x" top: "y" }}
        layer {{ name: "l" type: "EuclideanLoss" bottom: "y" bottom: "x"
          top: "l" }}
        """
        run_both(txt, {"x": _x(4, 3, seed=22)})
    finally:
        JGN._REGISTRY.pop(name)
        TGN._REGISTRY.pop(name)


# --------------------------------------------------------- random layers

def test_random_layers_draw_from_the_generator():
    """Dropout (train), STOCHASTIC pooling (train) and a random DummyData
    draw from the ``generator`` handed to apply: the same seed gives the
    same blobs, another seed others, dropout keeps about 1 - ratio of the
    units scaled by 1 / (1 - ratio), and no generator raises."""
    txt = """
    layer { name: "d" type: "Input" top: "x" }
    layer { name: "dr" type: "Dropout" bottom: "x" top: "dr"
      dropout_param { dropout_ratio: 0.25 } }
    layer { name: "po" type: "Pooling" bottom: "x" top: "po"
      pooling_param { pool: STOCHASTIC kernel_size: 2 stride: 2 } }
    layer { name: "dd" type: "DummyData" top: "g"
      dummy_data_param { shape { dim: 4000 }
        data_filler { type: "gaussian" std: 2 } } }
    """
    x = np.abs(_x(8, 16, 16, 4, seed=23)) + 0.1
    net = TGN.GraphNet(txt)
    p, s = net.init(torch.Generator().manual_seed(0), {"x": x},
                    device="cpu")

    def run(seed):
        return net.apply(p, s, {"x": x}, train=True,
                         generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    for k in ("dr", "po", "g"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]), k
    kept = (a["dr"] != 0).float().mean()
    assert abs(float(kept) - 0.75) < 0.01
    nz = a["dr"] != 0
    np.testing.assert_allclose(a["dr"][nz].numpy(),
                               (torch.as_tensor(x)[nz] / 0.75).numpy(),
                               rtol=1e-6)
    assert abs(float(a["g"].std()) - 2.0) < 0.1
    with pytest.raises(ValueError, match="generator"):
        net.apply(p, s, {"x": x}, train=True)
    # TEST phase: dropout is the identity, stochastic pooling the
    # deterministic weighted average
    ev, _ = net.apply(p, s, {"x": x}, train=False,
                      generator=torch.Generator())
    assert torch.equal(ev["dr"], torch.as_tensor(x))


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        TGN.GraphNet(INLINE["shared"][0]).init(torch.Generator(),
                                               INLINE["shared"][1]())
