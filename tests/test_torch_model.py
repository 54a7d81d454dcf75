"""Parity of the PyTorch port's MMS-QA model with the JAX package's, from
identical weights moved through ``convert.py``.  Tolerance: float32,
atol = rtol = 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as J
from mms_answer_selection_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from mms_answer_selection_tpu_torch.models import mms_qa as T

TOL = dict(rtol=1e-5, atol=1e-5)

# ends at a 3 x 2 x 6 map: fc1 reads an NHWC (h, w, c) flatten whose order
# a layout slip would scramble (V4 and V5 both end at 1 x 1)
WIDE_END = dataclasses.replace(
    J.MMSQAConfig(), vocab_size=40, embed_dim=8, question_len=12,
    answer_len=10, sim_measures=3,
    blocks=(J.ConvBlock(3, 3, 4, "max", 2, 2),
            J.ConvBlock(2, 2, 6, "ave", 2, 1)),
    fc1_dim=5)
V4_SMALL_VOCAB = dataclasses.replace(J.V4, vocab_size=100)
V3_SMALL = dataclasses.replace(J.V3, vocab_size=40, embed_dim=8,
                               question_len=14, answer_len=14,
                               blocks=(J.ConvBlock(3, 3, 4, "max", 2, 2),
                                       J.ConvBlock(2, 2, 4, "max", 2, 2)),
                               fc1_dim=6)

CONFIGS = {"v4": V4_SMALL_VOCAB, "wide_end": WIDE_END, "v3_cosine": V3_SMALL}


def _tcfg(jcfg):
    """The port's config with the same fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["blocks"] = tuple(T.ConvBlock(**dataclasses.asdict(b))
                             for b in jcfg.blocks)
    return T.MMSQAConfig(**fields)


def _weights(cfg, seed=0):
    """JAX init, then every tensor moved off its init value (W = 0 and
    zero running stats would hide mistakes) -> numpy trees."""
    rng = np.random.default_rng(seed)
    params, state = J.mms_qa_init(jax.random.PRNGKey(seed), cfg)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.2 * rng.normal(size=x.shape).astype(
            np.float32), params)
    state = jax.tree.map(
        lambda x: np.abs(rng.normal(size=x.shape)).astype(np.float32) + 0.3,
        state)
    return params, state


def _batch(cfg, n=5, seed=1, labels=True):
    rng = np.random.default_rng(seed)
    b = {"question": rng.integers(0, cfg.vocab_size + 3,
                                  (n, cfg.question_len)).astype(np.int32),
         "answer": rng.integers(0, cfg.vocab_size,
                                (n, cfg.answer_len)).astype(np.int32),
         "overlap_feat": rng.normal(size=(n, cfg.overlap_features)).astype(
             np.float32)}
    if labels:
        b["label"] = rng.integers(0, 2, (n,)).astype(np.int32)
    return b


def _run_both(cfg, train):
    params_np, state_np = _weights(cfg)
    batch = _batch(cfg)
    jout, jstate = J.mms_qa_apply(
        params_np, state_np, {k: jnp.asarray(v) for k, v in batch.items()},
        cfg, train=train, rng=jax.random.PRNGKey(5) if train else None)
    params, state = params_from_numpy(params_np, state_np, "cpu")
    tout, tstate = T.mms_qa_apply(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        _tcfg(cfg), train=train,
        generator=torch.Generator().manual_seed(5) if train else None)
    return jout, jstate, tout, tstate


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_eval_matches_jax(name):
    jout, jstate, tout, tstate = _run_both(CONFIGS[name], train=False)
    for key in ("logits", "prob", "loss"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   **TOL)
    for bn in jstate:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(tstate[bn][k].numpy(),
                                          np.asarray(jstate[bn][k]))


@pytest.mark.parametrize("name", ["v4", "wide_end"])
def test_apply_train_without_dropout_matches_jax(name):
    cfg = dataclasses.replace(CONFIGS[name], sim_dropout=0.0,
                              fc1_dropout=0.0)
    jout, jstate, tout, tstate = _run_both(cfg, train=True)
    for key in ("logits", "prob", "loss"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   **TOL)
    for bn in jstate:
        for k in ("mean", "var"):
            np.testing.assert_allclose(tstate[bn][k].numpy(),
                                       np.asarray(jstate[bn][k]), **TOL)


def test_flatten_order_is_nhwc():
    # permuting fc1's rows from (h, w, c) to (c, h, w) order must change the
    # logits: the ports agree on the order, not by accident of symmetry
    cfg = WIDE_END
    params_np, state_np = _weights(cfg)
    h, w, c = J._spatial_after_blocks(cfg)
    assert (h, w) == (3, 2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    params, state = params_from_numpy(params_np, state_np, "cpu")
    base, _ = T.mms_qa_apply(params, state, batch, _tcfg(cfg), train=False)
    fw = params["fc1"]["w"]
    perm = torch.arange(h * w * c).view(h, w, c).permute(2, 0, 1).reshape(-1)
    params["fc1"]["w"] = torch.cat([fw[perm], fw[h * w * c:]])
    moved, _ = T.mms_qa_apply(params, state, batch, _tcfg(cfg), train=False)
    assert not torch.allclose(base["logits"], moved["logits"], atol=1e-3)


def test_train_needs_a_generator():
    cfg = _tcfg(WIDE_END)
    params, state = T.mms_qa_init(cfg, generator=torch.Generator())
    batch = {k: torch.from_numpy(v) for k, v in _batch(WIDE_END).items()}
    with pytest.raises(ValueError):
        T.mms_qa_apply(params, state, batch, cfg, train=True)


@pytest.mark.parametrize("name", ["V3", "V4", "V4_2", "V5", "V4_WIDE"])
def test_init_tree_matches_jax(name):
    jcfg = dataclasses.replace(getattr(J, name), vocab_size=30,
                               sim_weight_init="xavier")
    jp, js = J.mms_qa_init(jax.random.PRNGKey(0), jcfg)
    tp, ts = T.mms_qa_init(_tcfg(jcfg), generator=torch.Generator())
    shapes = lambda tree: jax.tree.map(lambda x: tuple(x.shape), tree)  # noqa
    assert shapes(params_to_numpy(tp, ts)) == shapes((jp, js))
    # the published configs are field-for-field the same
    assert _tcfg(getattr(J, name)) == getattr(T, name)


def test_convert_round_trip_copies():
    params_np, state_np = _weights(WIDE_END)
    params, state = params_from_numpy(params_np, state_np, "cpu")
    back_p, back_s = params_to_numpy(params, state)
    for a, b in zip(jax.tree.leaves((params_np, state_np)),
                    jax.tree.leaves((back_p, back_s))):
        np.testing.assert_array_equal(a, b)
    params["embed"]["w"][0, 0] = 123.0        # no aliasing of the input
    assert params_np["embed"]["w"][0, 0] != 123.0


def test_init_writes_pretrained_vectors():
    cfg = dataclasses.replace(WIDE_END, vocab_size=12)
    pre = np.random.default_rng(3).normal(size=(10, 8)).astype(np.float32)
    tp, _ = T.mms_qa_init(_tcfg(cfg), generator=torch.Generator(),
                          pretrained=pre)
    jp, _ = J.mms_qa_init(jax.random.PRNGKey(0), cfg, pretrained=pre)
    np.testing.assert_array_equal(tp["embed"]["w"][:10].numpy(),
                                  np.asarray(jp["embed"]["w"][:10]))
    with pytest.raises(ValueError):
        T.mms_qa_init(_tcfg(cfg), generator=torch.Generator(),
                      pretrained=pre[:, :5])


@pytest.mark.parametrize("name", ["V3", "V4", "V5"])
def test_param_spec_matches_jax(name):
    jcfg = dataclasses.replace(getattr(J, name), vocab_size=30)
    jp, _ = J.mms_qa_init(jax.random.PRNGKey(0), jcfg)
    tp, _ = T.mms_qa_init(_tcfg(jcfg), generator=torch.Generator())
    tp["extra"] = {"v": torch.zeros(2), "deep": {"u": torch.zeros(1)}}
    jp = dict(jp, extra={"v": np.zeros(2), "deep": {"u": np.zeros(1)}})
    assert T.param_spec(tp, _tcfg(jcfg)) == J.param_spec(jp, jcfg)
