"""The multimodal side (configs[4]) of the port against the JAX package, on
CPU: the image-pair data pipeline, the siamese image-pair model and the
caption-to-image model (forward, gradients, five AdaDelta steps through
``Trainer(apply_fn=, init_fn=)``), an image pool served through
``QueryEngine.build_index_from_tokens``, and weights crossing between the
two packages.

The same seeded numpy inputs and weights (``convert.params_from_numpy``)
go to both.  Tolerances, with their reasons:

* data: exact (the same numpy code, the same generator draws);
* forward outputs: rtol 1e-5, atol 1e-5 (float32; convolutions, BN means
  and the pair maps sum in another order);
* parameter gradients: within 1e-4 of each leaf's largest |value|, except
  where the true gradient is 0 and what either package computes is
  rounding noise: the conv biases (each feeds a train-mode BN, which
  subtracts the batch mean) and the image-pair model's score bias (it
  adds to both scores of a pair, and the loss reads their difference);
  those are held to 1e-4 of their weight's largest gradient;
* five training steps: losses rtol 1e-4; params, BN state and AdaDelta
  state rtol 1e-4, atol 1e-4, the conv biases (and the BN running means
  that follow them) to the band AdaDelta allows them, both packages' moves
  of at most steps x lr_mult 2 x its normalized step;
* the image pool: identical top-k indices, scores rtol 1e-5;
* checkpoints across packages: scores within 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.data import pair_image as JD
from mms_answer_selection_tpu.models import caption_image as JC
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.models import pair_image as JP
from mms_answer_selection_tpu.ops.embed import embed_lookup as j_embed_lookup
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    Trainer as JTrainer,
    TrainerConfig as JTrainerConfig,
)
from mms_answer_selection_tpu.training import checkpoint as JCK
from mms_answer_selection_tpu.utils.caffemodel import save_blob_binaryproto
from mms_answer_selection_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from mms_answer_selection_tpu_torch.data import pair_image as TD
from mms_answer_selection_tpu_torch.models import caption_image as TC
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.models import pair_image as TP
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
)
from mms_answer_selection_tpu_torch.training import checkpoint as TCK
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves, tree_map

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
ADADELTA_STEP = (5e-7 / 0.05) ** 0.5
RECIPE = dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
              delta=5e-7, weight_decay=5e-4)

# the JAX package's caption test config, and the published defaults
SMALL_CAPTION = dict(vocab_size=50, embed_dim=16, caption_len=6, height=10,
                     width=10, channels=1, blocks=((3, 3, 8, "max", 2, 2),),
                     sim_measures=2)
DEFAULT_CAPTION = dict(vocab_size=60)
PAIR = dict(height=12, width=12, channels=1,
            blocks=((3, 3, 4, "max", 2, 2), (2, 2, 6, "max", 1, 1)),
            fc_dim=8)


def _cfgs(jcls, tcls, kw):
    """The same config in both packages (blocks as each one's ConvBlock)."""
    kw = dict(kw)
    blocks = kw.pop("blocks", None)
    if blocks is None:
        return jcls(**kw), tcls(**kw)
    return (jcls(**kw, blocks=tuple(JQ.ConvBlock(*b) for b in blocks)),
            tcls(**kw, blocks=tuple(TQ.ConvBlock(*b) for b in blocks)))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                        f"{prefix}{k}.")]
    return [(prefix[:-1], np.asarray(tree))]


def _t_named(tree):
    return _named(tree_map(lambda t: t.detach().cpu().numpy(), tree))


def _grads_close(t_grads, j_grads):
    t, j = dict(_t_named(t_grads)), dict(_named(j_grads))
    assert t.keys() == j.keys()
    for name, jg in j.items():
        err = float(np.abs(t[name] - jg).max())
        if name.endswith(".b") and name[:-2] in NOISY_BIASES:
            scale = float(np.abs(j[name[:-2] + ".w"]).max())
        else:
            scale = float(np.abs(jg).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


NOISY_BIASES = ("conv0", "conv1", "score")


def _t_grads(apply_fn, params, state, batch, cfg):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    out, new_state = apply_fn(p, state, batch, cfg, train=True)
    grads = torch.autograd.grad(out["loss"], leaves)
    it = iter(grads)
    return out, new_state, tree_map(lambda _: next(it), params)


def _j_grads(apply_fn, params, state, batch, cfg):
    def loss(p):
        out, ns = apply_fn(p, state, batch, cfg, train=True)
        return out["loss"], (out, ns)

    (_, (out, ns)), g = jax.value_and_grad(loss, has_aux=True)(params)
    return out, ns, g


def _assert_out(t_out, j_out, keys):
    for k in keys:
        np.testing.assert_allclose(t_out[k].detach().numpy(),
                                   np.asarray(j_out[k]), err_msg=k,
                                   **OUT_TOL)


def _caption_batch(rng, n, cfg, planted=False):
    if planted:   # the JAX test's signal: pixel row f encodes token f
        first = rng.integers(0, 8, n)
        caption = np.stack([np.full(cfg.caption_len, f) for f in first])
        pos = np.zeros((n, cfg.height, cfg.width, cfg.channels), np.float32)
        for i, f in enumerate(first):
            pos[i, f, :, 0] = 2.0
        pos += 0.1 * rng.normal(size=pos.shape).astype(np.float32)
    else:
        caption = rng.integers(0, cfg.vocab_size, (n, cfg.caption_len))
        pos = rng.normal(size=(n, cfg.height, cfg.width,
                               cfg.channels)).astype(np.float32)
    neg = rng.normal(size=pos.shape).astype(np.float32)
    return {"caption": caption.astype(np.int32), "image_pos": pos,
            "image_neg": neg}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# -------------------------------------------------------------------- data
@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The synthetic pair and image-list corpora written by each package."""
    root = tmp_path_factory.mktemp("images")
    out = {}
    for name, mod in (("j", JD), ("t", TD)):
        d = root / name
        out[name] = (d, mod.synthetic_pair_corpus(str(d / "pairs"),
                                                  n_pairs=10, hw=12,
                                                  channels=2, seed=5),
                     mod.synthetic_image_corpus(str(d / "list"),
                                                n_images=9, hw=12,
                                                channels=2, seed=6))
    return out


def test_synthetic_corpora_are_the_same_files(corpora):
    jd, td = corpora["j"][0], corpora["t"][0]
    for sub in ("pairs", "list"):
        names = sorted(os.listdir(jd / sub))
        assert names == sorted(os.listdir(td / sub))
        for n in names:
            assert (jd / sub / n).read_bytes() == (td / sub / n).read_bytes()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=False),
    dict(rand_skip=7, crop_size=8, mirror=True, scale=0.5),
    dict(rand_skip=3, crop_size=8, train=False, mean=True),
], ids=["shuffle", "in-order", "skip-crop-mirror", "center-crop-mean"])
@pytest.mark.parametrize("kind", ["pair", "list"])
def test_datasets_give_the_same_batches_over_two_epochs(corpora, kw, kind):
    d, pair_list, image_list = corpora["t"]
    list_file, root = ((pair_list, d / "pairs") if kind == "pair"
                       else (image_list, d / "list"))
    kw = dict(kw)
    if kw.pop("mean", False):
        kw["mean"] = TD.compute_image_mean(list_file, root=str(root))
        np.testing.assert_array_equal(
            kw["mean"], JD.compute_image_mean(list_file, root=str(root)))
    cls = "PairImageDataset" if kind == "pair" else "ImageListDataset"
    if kind == "list":
        kw.setdefault("shuffle", True)
    got = getattr(TD, cls)(list_file, 4, root=str(root), seed=3, **kw)
    want = getattr(JD, cls)(list_file, 4, root=str(root), seed=3, **kw)
    assert got.cursor == want.cursor
    for _ in range(6):                    # 24 rows: two passes and more
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_array_equal(got.order, want.order)


def test_parse_list_and_mean_file(tmp_path):
    text = "a.npy b.npy 0.5 1.5 1\nshort row\nx.npy y.npy 0 0 0\n"
    assert TD.parse_pair_list(text) == JD.parse_pair_list(text)
    with pytest.raises(FileNotFoundError):
        TD.parse_pair_list(str(tmp_path / "missing.txt"))
    mean = np.random.default_rng(0).normal(size=(5, 4, 3)).astype(np.float32)
    path = str(tmp_path / "mean.binaryproto")
    for legacy in (True, False):
        save_blob_binaryproto(path, mean.transpose(2, 0, 1)[None],
                              legacy_dims=legacy)
        np.testing.assert_array_equal(TD.load_mean_hwc(path),
                                      JD.load_mean_hwc(path))
        np.testing.assert_array_equal(TD.load_mean_hwc(path), mean)
    save_blob_binaryproto(path, mean.reshape(-1), legacy_dims=False)
    with pytest.raises(ValueError, match="expected"):
        TD.load_mean_hwc(path)


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module", params=["small", "default"])
def caption_model(request):
    kw = SMALL_CAPTION if request.param == "small" else DEFAULT_CAPTION
    jcfg, tcfg = _cfgs(JC.CaptionImageConfig, TC.CaptionImageConfig, kw)
    jp, js = jax.device_get(JC.caption_image_init(jax.random.PRNGKey(4),
                                                  jcfg))
    # BN running statistics away from their zero init, so eval mode is
    # exercised with real values
    rng = np.random.default_rng(11)
    js = {k: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32)
              * 0.1, "var": rng.random(v["var"].shape).astype(np.float32)
              + 0.5} for k, v in js.items()}
    tp, ts = params_from_numpy(jp, js, "cpu")
    return jcfg, tcfg, (jp, js), (tp, ts)


def test_caption_config_and_patch_grid(caption_model):
    jcfg, tcfg, _, _ = caption_model
    assert tcfg.patch_grid() == jcfg.patch_grid()
    if tcfg.height == 16:     # the published default: P = 25 patches
        assert tcfg.patch_grid() == (5, 5)


def test_caption_init_draws_the_jax_shapes(caption_model):
    jcfg, tcfg, (jp, js), _ = caption_model
    tp, ts = TC.caption_image_init(tcfg, generator=torch.Generator()
                                   .manual_seed(0))
    for (nj, xj), (nt, xt) in zip(_named({"p": jp, "s": js}),
                                  _t_named({"p": tp, "s": ts})):
        assert nj == nt and xj.shape == xt.shape and xt.dtype == np.float32
    assert float(ts["bn0"]["var"].abs().max()) == 0.0
    assert torch.equal(tp["bn0"]["shift"], torch.full_like(
        tp["bn0"]["shift"], 1e-3))


@pytest.mark.parametrize("train", [False, True])
def test_encode_image_matches_jax(caption_model, train):
    jcfg, tcfg, (jp, js), (tp, ts) = caption_model
    images = np.random.default_rng(1).normal(size=(
        5, tcfg.height, tcfg.width, tcfg.channels)).astype(np.float32)
    jt, jns = JC.encode_image(jp, js, jnp.asarray(images), jcfg, train=train)
    tt, tns = TC.encode_image(tp, ts, torch.as_tensor(images), tcfg,
                              train=train)
    gh, gw = tcfg.patch_grid()
    assert tt.shape == (5, gh * gw, tcfg.embed_dim)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt), **OUT_TOL)
    for (n, x), (_, y) in zip(_t_named(tns), _named(jns)):
        np.testing.assert_allclose(x, y, err_msg=n, **OUT_TOL)


def test_caption_score_matches_jax_and_its_definition(caption_model):
    jcfg, tcfg, (jp, _), (tp, _) = caption_model
    rng = np.random.default_rng(2)
    d, p = tcfg.embed_dim, np.prod(tcfg.patch_grid())
    cap = rng.normal(size=(4, tcfg.caption_len, d)).astype(np.float32)
    img = rng.normal(size=(4, p, d)).astype(np.float32)
    got = TC.caption_image_score(tp, torch.as_tensor(cap),
                                 torch.as_tensor(img), tcfg).numpy()
    np.testing.assert_allclose(got, np.asarray(JC.caption_image_score(
        jp, jnp.asarray(cap), jnp.asarray(img), jcfg)), **OUT_TOL)
    w = jp["sim"]["w"].astype(np.float64)
    want = [sum((cap[n] @ w[m] @ img[n].T).max(axis=1).sum()
                for m in range(tcfg.sim_measures)) for n in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_caption_score_gradient_splits_ties_as_jax(caption_model):
    """Tied patches (a duplicated image token) share the max's gradient
    evenly in both packages (``torch.amax``, ``jnp.max``)."""
    jcfg, tcfg, (jp, _), (tp, _) = caption_model
    rng = np.random.default_rng(3)
    d, p = tcfg.embed_dim, int(np.prod(tcfg.patch_grid()))
    cap = rng.normal(size=(2, tcfg.caption_len, d)).astype(np.float32)
    img = np.repeat(rng.normal(size=(2, 1, d)).astype(np.float32), p, 1)
    jg = jax.grad(lambda x: jnp.sum(JC.caption_image_score(
        jp, jnp.asarray(cap), x, jcfg)))(jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    tg, = torch.autograd.grad(TC.caption_image_score(
        tp, torch.as_tensor(cap), x, tcfg).sum(), x)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **OUT_TOL)
    np.testing.assert_allclose(tg.numpy()[:, 0], tg.numpy()[:, -1],
                               rtol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_caption_apply_and_gradients_match_jax(caption_model, train):
    jcfg, tcfg, (jp, js), (tp, ts) = caption_model
    batch = _caption_batch(np.random.default_rng(7), 6, tcfg)
    keys = ("score_pos", "score_neg", "loss", "rank_accuracy")
    if not train:
        jo, _ = JC.caption_image_apply(jp, js, _j(batch), jcfg, train=False)
        to, _ = TC.caption_image_apply(tp, ts, _t(batch), tcfg, train=False)
        _assert_out(to, jo, keys)
        return
    jo, jns, jg = _j_grads(JC.caption_image_apply, jp, js, _j(batch), jcfg)
    to, tns, tg = _t_grads(TC.caption_image_apply, tp, ts, _t(batch), tcfg)
    _assert_out(to, jo, keys)
    for (n, x), (_, y) in zip(_t_named(tns), _named(jns)):
        np.testing.assert_allclose(x, y, err_msg=n, **OUT_TOL)
    _grads_close(tg, jg)


@pytest.fixture(scope="module")
def pair_model():
    jcfg, tcfg = _cfgs(JP.PairImageConfig, TP.PairImageConfig, PAIR)
    jp, js = jax.device_get(JP.pair_image_init(jax.random.PRNGKey(8), jcfg))
    tp, ts = params_from_numpy(jp, js, "cpu")
    return jcfg, tcfg, (jp, js), (tp, ts)


def _pair_batch(rng, n, cfg):
    shape = (n, cfg.height, cfg.width, cfg.channels)
    return {"img1": rng.normal(size=shape).astype(np.float32),
            "img2": rng.normal(size=shape).astype(np.float32),
            "label": (rng.random(n) < 0.5).astype(np.float32)}


def test_pair_image_init_shapes():
    for kw in (PAIR, {}):
        jcfg, tcfg = _cfgs(JP.PairImageConfig, TP.PairImageConfig, kw)
        jp, js = JP.pair_image_init(jax.random.PRNGKey(0), jcfg)
        tp, ts = TP.pair_image_init(tcfg, generator=torch.Generator()
                                    .manual_seed(0))
        assert [(n, x.shape) for n, x in _named({"p": jp, "s": js})] == \
            [(n, x.shape) for n, x in _t_named({"p": tp, "s": ts})]


@pytest.mark.parametrize("train", [False, True])
def test_pair_encode_and_apply_match_jax(pair_model, train):
    jcfg, tcfg, (jp, js), (tp, ts) = pair_model
    batch = _pair_batch(np.random.default_rng(12), 6, tcfg)
    js_, jns = JP.encode(jp, js, jnp.asarray(batch["img1"]), jcfg,
                         train=train)
    ts_, tns = TP.encode(tp, ts, torch.as_tensor(batch["img1"]), tcfg,
                         train=train)
    np.testing.assert_allclose(ts_.detach().numpy(), np.asarray(js_),
                               **OUT_TOL)
    keys = ("score1", "score2", "loss", "rank_accuracy")
    if not train:
        jo, _ = JP.pair_image_apply(jp, js, _j(batch), jcfg, train=False)
        to, _ = TP.pair_image_apply(tp, ts, _t(batch), tcfg, train=False)
        _assert_out(to, jo, keys)
        return
    jo, jns, jg = _j_grads(JP.pair_image_apply, jp, js, _j(batch), jcfg)
    to, tns, tg = _t_grads(TP.pair_image_apply, tp, ts, _t(batch), tcfg)
    _assert_out(to, jo, keys)
    for (n, x), (_, y) in zip(_t_named(tns), _named(jns)):
        np.testing.assert_allclose(x, y, err_msg=n, **OUT_TOL)
    _grads_close(tg, jg)


def test_both_images_share_one_set_of_bn_statistics(pair_model):
    """img1 ++ img2 run as one batch: two encoder calls would give other
    batch statistics and another loss."""
    _, tcfg, _, (tp, ts) = pair_model
    batch = _t(_pair_batch(np.random.default_rng(13), 6, tcfg))
    out, _ = TP.pair_image_apply(tp, ts, batch, tcfg, train=True)
    s1, _ = TP.encode(tp, ts, batch["img1"], tcfg, train=True)
    assert not torch.allclose(out["score1"], s1, rtol=1e-3)
    both, _ = TP.encode(tp, ts, torch.cat([batch["img1"], batch["img2"]]),
                        tcfg, train=True)
    assert torch.equal(out["score1"], both[:6])


# --------------------------------------------------------------- training
def _jax_pair_init(key, cfg, pretrained=None):
    return JP.pair_image_init(key, cfg)


TRAIN_CASES = {
    "caption": (SMALL_CAPTION, JC.CaptionImageConfig, TC.CaptionImageConfig,
                (JC.caption_image_apply, JC.caption_image_init),
                (TC.caption_image_apply, TC.caption_image_init)),
    "pair": (PAIR, JP.PairImageConfig, TP.PairImageConfig,
             (JP.pair_image_apply, _jax_pair_init),
             (TP.pair_image_apply, TP.pair_image_init)),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def five_steps(request, tmp_path_factory):
    """Five AdaDelta steps of each package's Trainer(apply_fn=, init_fn=)
    from the same weights on the same batches."""
    kw, jcls, tcls, (japply, jinit), (tapply, tinit) = \
        TRAIN_CASES[request.param]
    jcfg, tcfg = _cfgs(jcls, tcls, kw)
    jt = JTrainer(jcfg, JTrainerConfig(solver=JSolverConfig(**RECIPE),
                                       batch_size=8),
                  apply_fn=japply, init_fn=jinit, donate=False)
    jp, js, jo = jt.init()
    tt = Trainer(tcfg, TrainerConfig(solver=SolverConfig(**RECIPE),
                                     batch_size=8), device="cpu",
                 apply_fn=tapply, init_fn=tinit)
    tt.init()
    tp, ts = params_from_numpy(*jax.device_get((jp, js)), "cpu")
    to = tt.solver.init(tp)
    rng = np.random.default_rng(21)
    if request.param == "caption":
        batches = [_caption_batch(rng, 8, tcfg, planted=True)
                   for _ in range(5)]
    else:
        d = tmp_path_factory.mktemp("pairs")
        ds = TD.PairImageDataset(TD.synthetic_pair_corpus(
            str(d), n_pairs=12, hw=12, seed=2), 8, root=str(d), seed=4)
        batches = [{k: v for k, v in next(ds).items() if k != "angles"}
                   for _ in range(5)]
    jl, tl = [], []
    for step, b in enumerate(batches):
        jp, js, jo, loss = jt._train_step(jp, js, jo, _j(b),
                                          jnp.asarray(step),
                                          jax.random.PRNGKey(step))
        jl.append(float(loss))
        tp, ts, to, loss = tt._train_step(tp, ts, to, _t(b), step)
        tl.append(float(loss))
    return (jl, jp, js, jo), (tl, tp, ts, to)


def test_five_steps_losses_match(five_steps):
    (jl, *_), (tl, *_) = five_steps
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    assert np.isfinite(tl).all()


NOISE = tuple(f"{acc}{name}.b" for acc in ("", "h.", "h2.")
              for name in NOISY_BIASES) + ("bn0.mean", "bn1.mean")
BAND = 2 * 5 * 2 * ADADELTA_STEP


def test_five_steps_params_and_state_match(five_steps):
    (_, jp, js, jo), (_, tp, ts, to) = five_steps
    for t_tree, j_tree in ((tp, jp), (ts, js), (to, jo)):
        for (n, x), (_, y) in zip(_t_named(t_tree), _named(j_tree)):
            if n in NOISE:
                assert np.abs(x - y).max() <= BAND, (n, np.abs(x - y).max())
            else:
                np.testing.assert_allclose(x, y, err_msg=n, **STEP_TOL)


def test_caption_training_learns_the_planted_alignment():
    """The JAX package's criterion: the mean rank accuracy of the last 8
    of 40 steps above max(0.6, the first 8's)."""
    _, tcfg = _cfgs(JC.CaptionImageConfig, TC.CaptionImageConfig,
                    SMALL_CAPTION)
    tt = Trainer(tcfg, TrainerConfig(solver=SolverConfig(
        solver_type="adadelta", weight_decay=0.0), seed=2), device="cpu",
        apply_fn=TC.caption_image_apply, init_fn=TC.caption_image_init)
    p, s, o = tt.init()
    rng = np.random.default_rng(3)
    accs = []
    for i in range(40):
        b = _t(_caption_batch(rng, 16, tcfg, planted=True))
        out, _ = TC.caption_image_apply(p, s, b, tcfg, train=True)
        accs.append(float(out["rank_accuracy"]))
        p, s, o, _ = tt._train_step(p, s, o, b, i)
    assert np.mean(accs[-8:]) > max(0.6, np.mean(accs[:8]))


def test_trainer_defaults_stay_the_qa_model():
    tt = Trainer(TQ.MMSQAConfig(vocab_size=20, question_len=8,
                                answer_len=8,
                                blocks=(TQ.ConvBlock(3, 3, 2, "ave", 2, 2),)),
                 TrainerConfig(), device="cpu")
    assert tt.apply_fn is TQ.mms_qa_apply and tt.init_fn is TQ.mms_qa_init
    p, _, _ = tt.init(pretrained=np.ones((3, 50), np.float32))
    assert torch.equal(p["embed"]["w"][:3], torch.ones(3, 50))


# -------------------------------------------------------------- image pool
@pytest.fixture(scope="module")
def image_pool():
    jcfg, tcfg = _cfgs(JC.CaptionImageConfig, TC.CaptionImageConfig,
                       dict(SMALL_CAPTION, vocab_size=64))
    jp, js = jax.device_get(JC.caption_image_init(jax.random.PRNGKey(0),
                                                  jcfg))
    rng = np.random.default_rng(7)
    # a trained model's running variance (at its zero init eval-mode BN
    # divides by sqrt(1e-9) and magnifies rounding 3e4-fold)
    js = {k: {"mean": 0.1 * rng.normal(size=v["mean"].shape).astype(
        np.float32), "var": rng.random(v["var"].shape).astype(np.float32)
        + 0.5} for k, v in js.items()}
    images = rng.normal(size=(24, 10, 10, 1)).astype(np.float32)
    tokens = np.array(JC.encode_image(jp, js, jnp.asarray(images), jcfg,
                                        train=False)[0])
    cap_ids = rng.integers(0, 64, (3, 6))
    cap_tokens = np.array(j_embed_lookup(jp["embed"], jnp.asarray(cap_ids)))
    qa = dict(vocab_size=64, embed_dim=16, question_len=6, answer_len=6,
              sim_measures=2)
    return jp, js, images, tokens, cap_tokens, JQ.MMSQAConfig(**qa), \
        TQ.MMSQAConfig(**qa), tcfg


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_image_pool_topk_equals_jax(image_pool, pool_dtype):
    jp, js, images, tokens, cap_tokens, jqa, tqa, tcfg = image_pool
    jeng = JEngine(jp, jqa, interpret=True, pool_dtype=(
        jnp.bfloat16 if pool_dtype == "bf16" else pool_dtype))
    jeng.build_index_from_tokens(tokens)
    jv, ji = jeng.query(jnp.asarray(cap_tokens), k=5)
    tp, ts = params_from_numpy(jp, js, "cpu")
    eng = QueryEngine(tp, tqa, pool_dtype=pool_dtype, device="cpu")
    # the port's own encoder gives the pool, from the same images
    t_tokens, _ = TC.encode_image(tp, ts, torch.as_tensor(images), tcfg,
                                  train=False)
    np.testing.assert_allclose(t_tokens.numpy(), tokens, **OUT_TOL)
    eng.build_index_from_tokens(tokens)
    tv, ti = eng.query(torch.as_tensor(cap_tokens), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    # chunked = unchunked, from a host source one chunk at a time (the
    # plain scorer's BLAS blocks by the slab's size: last-bit differences)
    small = QueryEngine(tp, tqa, pool_dtype=pool_dtype, chunk_size=7,
                        device="cpu").build_index_from_tokens(
                            torch.as_tensor(tokens))
    sv, si = small.query(torch.as_tensor(cap_tokens), k=5)
    assert torch.equal(si, ti)
    np.testing.assert_allclose(sv.numpy(), tv.numpy(), rtol=1e-6)
    if pool_dtype == "bf16":
        # and the top-1 is the model's own f32 scorer's best image
        for qi in range(3):
            scores = TC.caption_image_score(
                tp, torch.as_tensor(cap_tokens[qi:qi + 1]).repeat(24, 1, 1),
                torch.as_tensor(tokens), tcfg)
            assert int(ti[qi, 0]) == int(torch.argmax(scores))


def test_image_pool_has_no_ids_to_rerank(image_pool):
    jp, js, _, tokens, cap_tokens, _, tqa, _ = image_pool
    tp, ts = params_from_numpy(jp, js, "cpu")
    eng = QueryEngine(tp, tqa, device="cpu").build_index_from_tokens(tokens)
    with pytest.raises(ValueError, match="from-tokens"):
        eng.query_rerank(ts, torch.zeros(1, 6, dtype=torch.int64))
    with pytest.raises(ValueError, match="ids-built"):
        eng.add_candidates(torch.zeros(1, 6, dtype=torch.int64))


# --------------------------------------------------- weights across packages
@pytest.mark.parametrize("family", ["caption", "pair"])
def test_convert_carries_the_trees_with_bn_state(caption_model, pair_model,
                                                 family):
    _, _, (jp, js), _ = caption_model if family == "caption" else pair_model
    tp, ts = params_from_numpy(jp, js, "cpu")
    assert set(ts) == set(js) and all(set(ts[k]) == {"mean", "var"}
                                      for k in ts)
    back_p, back_s = params_to_numpy(tp, ts)
    for (n, x), (_, y) in zip(_named({"p": back_p, "s": back_s}),
                              _named({"p": jp, "s": js})):
        np.testing.assert_array_equal(x, y, err_msg=n)
        assert x.dtype == y.dtype


def test_caption_checkpoints_cross_the_packages(caption_model, tmp_path):
    jcfg, tcfg, (jp, js), _ = caption_model
    batch = _caption_batch(np.random.default_rng(30), 4, tcfg)
    want, _ = JC.caption_image_apply(jp, js, _j(batch), jcfg, train=False)
    # JAX writes, the port reads
    path = JCK.save_checkpoint(str(tmp_path / "j"), 3,
                               {"params": jp, "state": js}, prefix="best",
                               meta={"dev_map": 0.5})
    raw, meta = TCK.load_checkpoint(path)
    assert meta["dev_map"] == 0.5
    tp, ts = params_from_numpy(raw["params"], raw["state"], "cpu")
    got, _ = TC.caption_image_apply(tp, ts, _t(batch), tcfg, train=False)
    _assert_out(got, want, ("score_pos", "score_neg", "loss"))
    # the port writes, JAX reads
    path = TCK.save_checkpoint(str(tmp_path / "t"), 4,
                               {"params": tp, "state": ts}, prefix="best")
    back, _ = JCK.load_checkpoint(path)
    again, _ = JC.caption_image_apply(
        jax.tree.map(jnp.asarray, back["params"]),
        jax.tree.map(jnp.asarray, back["state"]), _j(batch), jcfg,
        train=False)
    for k in ("score_pos", "score_neg", "loss"):
        np.testing.assert_allclose(np.asarray(again[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    # and restored into the port's own template
    template = {"params": tp, "state": ts}
    restored, _ = TCK.load_checkpoint(path, template=template)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(template)))


def test_pair_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(TP.PairImageConfig)] == \
        [f.name for f in dataclasses.fields(JP.PairImageConfig)]
    assert [f.name for f in dataclasses.fields(TC.CaptionImageConfig)] == \
        [f.name for f in dataclasses.fields(JC.CaptionImageConfig)]
    jcfg, tcfg = JC.CaptionImageConfig(), TC.CaptionImageConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
