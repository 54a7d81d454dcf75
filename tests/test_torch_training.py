"""The port's training slice against the JAX package's, on CPU: the solver
family, the train step (5 steps, iter_size 1 and 2, metric W from zeros
and from xavier) and ``fit`` (losses, dev MAP/MRR/AUC, best step and the
early-stop iteration).

Weights cross over through ``convert.params_from_numpy``, batches are the
same numpy rows, and dropout is off, so both packages compute the same
numbers up to float32 summation order.  Tolerances, with their reasons:

* solver: rtol 1e-5, atol 1e-7 -- the same element-wise float32 formulas;
  XLA may fuse them into FMAs and evaluate pow/exp/sqrt with its own
  routines, a few ulps per step.
* train step and ``fit``: rtol 1e-4, atol 1e-5 on losses, params, BN state
  and metrics -- the forward and backward sum in another order (einsum,
  conv, BN means), and the zeros-init W makes BN divide by sqrt(1e-9) at
  step 0, which scales those roundings up before AdaDelta normalizes them.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.data import prepare_trec_qa, synthetic_corpus
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    Trainer as JTrainer,
    TrainerConfig as JTrainerConfig,
    make_solver as j_make_solver,
)
from mms_answer_selection_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
    learning_rate,
    make_solver,
)
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

SOLVER_TOL = dict(rtol=1e-5, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# AdaDelta's largest step while its accumulators are near zero:
# lr * sqrt(delta / (1 - momentum)) = sqrt(5e-7 / 0.05), per unit lr_mult
ADADELTA_STEP = (5e-7 / 0.05) ** 0.5


def _named_leaves(j_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(j_tree)
    return [(".".join(str(getattr(k, "key", k)) for k in path), np.asarray(x))
            for path, x in flat]


def _assert_trees_close(t_tree, j_tree, noise=(), band=0.0, **tol):
    """Leaf by leaf; leaves named in ``noise`` (a name prefix) are only held
    to |t - j| <= band."""
    j_leaves = _named_leaves(j_tree)
    t_leaves = tree_leaves(t_tree)
    assert len(j_leaves) == len(t_leaves)
    for (name, j), t in zip(j_leaves, t_leaves):
        t = t.detach().cpu().numpy()
        if any(name.startswith(n) for n in noise):
            assert np.abs(t - j).max() <= band, (name, np.abs(t - j).max())
        else:
            np.testing.assert_allclose(t, j, err_msg=name, **tol)


# ------------------------------------------------------------------ solver
def _solver_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"w": (6, 3), "b": (3,)}, "sim": {"w": (2, 3, 3)},
              "conv0": {"w": (2, 2, 2, 3), "b": (3,)},
              "bn0": {"scale": (3,), "shift": (3,)},
              "fc1": {"w": (4, 2), "b": (2,)}, "extra": {"v": (5,)}}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


# every solver on the fixed policy; every policy on SGD; clipping at a
# norm that bites, at 0 (freezes) and off; iter_size 2; L1; no decay
SOLVER_CASES = (
    [dict(solver_type=t) for t in ("sgd", "nesterov", "adagrad", "rmsprop",
                                   "adadelta", "adam")]
    + [dict(solver_type="sgd", lr_policy="step", stepsize=2, gamma=0.5),
       dict(solver_type="sgd", lr_policy="exp", gamma=0.9),
       dict(solver_type="sgd", lr_policy="inv", gamma=0.1, power=0.75),
       dict(solver_type="sgd", lr_policy="multistep", stepvalues=(1, 3),
            gamma=0.3),
       dict(solver_type="sgd", lr_policy="poly", max_iter=10, power=2.0),
       dict(solver_type="sgd", lr_policy="sigmoid", gamma=-0.5, stepsize=2),
       dict(solver_type="adadelta", clip_gradients=0.5),
       dict(solver_type="adam", clip_gradients=0.0, weight_decay=0.0),
       dict(solver_type="adadelta", iter_size=2),
       dict(solver_type="rmsprop", iter_size=2, clip_gradients=1.5),
       dict(solver_type="adagrad", regularization_type="L1",
            weight_decay=0.01),
       dict(solver_type="nesterov", regularization_type="L1",
            weight_decay=0.02, iter_size=2),
       dict(solver_type="sgd", weight_decay=0.0, base_lr=0.3)])


@pytest.mark.parametrize("case", SOLVER_CASES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in
                                                c.items()))
def test_solver_apply_matches_jax(case):
    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=5e-3) | case
    params_np = _solver_tree(0)
    spec_j = JQ.param_spec(params_np, JQ.V4)
    j_solver = j_make_solver(JSolverConfig(**kw), spec_j)
    t_params, _ = params_from_numpy(params_np, {}, "cpu")
    spec_t = TQ.param_spec(t_params, TQ.V4)
    assert spec_t == spec_j
    t_solver = make_solver(SolverConfig(**kw), spec_t)
    j_params, j_state = params_np, j_solver.init(params_np)
    t_state = t_solver.init(t_params)
    for step in range(4):
        grads_np = jax.tree.map(lambda x: x * 3.0, _solver_tree(step + 1))
        j_params, j_state = j_solver.apply(j_params, grads_np, j_state, step)
        t_grads, _ = params_from_numpy(grads_np, {}, "cpu")
        t_params, t_state = t_solver.apply(t_params, t_grads, t_state, step)
    _assert_trees_close(t_params, j_params, **SOLVER_TOL)
    _assert_trees_close(t_state, j_state, **SOLVER_TOL)
    if case.get("clip_gradients") == 0.0:   # clip 0 (no decay) freezes
        _assert_trees_close(t_params, params_np, rtol=0, atol=0)


def test_learning_rate_policies_match_jax():
    from mms_answer_selection_tpu.training.optim import learning_rate as j_lr
    for case in SOLVER_CASES:
        cfg = dict(base_lr=0.05) | case
        for step in (0, 1, 2, 3, 7):
            np.testing.assert_allclose(
                float(learning_rate(SolverConfig(**cfg), step)),
                float(j_lr(JSolverConfig(**cfg), step)), rtol=1e-6)
    with pytest.raises(ValueError):
        learning_rate(SolverConfig(lr_policy="step", stepsize=0), 1)


def test_solver_leaves_its_inputs_untouched():
    params, _ = params_from_numpy(_solver_tree(0), {}, "cpu")
    grads, _ = params_from_numpy(_solver_tree(1), {}, "cpu")
    before = [p.clone() for p in tree_leaves(params)]
    solver = make_solver(SolverConfig())
    state = solver.init(params)
    new, _ = solver.apply(params, grads, state, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert not torch.equal(new["sim"]["w"], params["sim"]["w"])


# -------------------------------------------------------------- train step
def _small_cfg(**kw):
    """V4-shaped: bilinear M=4 with bias, two ave-pool conv blocks, narrow
    channels, a vocab of about 200 words, dropout off."""
    return dataclasses.replace(JQ.V4, **(dict(
        vocab_size=200, embed_dim=12, question_len=12, answer_len=10,
        blocks=(JQ.ConvBlock(3, 3, 6, "ave", 2, 2),
                JQ.ConvBlock(2, 2, 8, "ave", 3, 1)),
        fc1_dim=8, sim_dropout=0.0, fc1_dropout=0.0) | kw))


def _tcfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["blocks"] = tuple(TQ.ConvBlock(**dataclasses.asdict(b))
                             for b in jcfg.blocks)
    return TQ.MMSQAConfig(**fields)


def _t_trainer_cfg(jtcfg):
    kw = {f.name: getattr(jtcfg, f.name) for f in dataclasses.fields(jtcfg)}
    kw["solver"] = SolverConfig(**dataclasses.asdict(jtcfg.solver))
    return TrainerConfig(**kw)


def _batches(cfg, n_steps, batch_size, iter_size, seed=3):
    rng = np.random.default_rng(seed)
    shape = (iter_size, batch_size) if iter_size > 1 else (batch_size,)
    return [{"question": rng.integers(0, cfg.vocab_size,
                                      shape + (cfg.question_len,)).astype(
                                          np.int32),
             "answer": rng.integers(0, cfg.vocab_size,
                                    shape + (cfg.answer_len,)).astype(
                                        np.int32),
             "overlap_feat": rng.random(shape + (2,)).astype(np.float32),
             "label": (rng.random(shape) < 0.4).astype(np.int32)}
            for _ in range(n_steps)]


RECIPE = dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
              delta=5e-7, weight_decay=5e-4)


@pytest.fixture(scope="module", params=[("zeros", 1), ("zeros", 2),
                                        ("xavier", 1), ("xavier", 2)],
                ids=lambda p: f"{p[0]}-iter{p[1]}")
def five_steps(request):
    """Five train steps of both packages from the same init and batches:
    (per-step losses, params, BN state, solver state) of each."""
    init, iter_size = request.param
    jcfg = _small_cfg(sim_weight_init=init)
    jtcfg = JTrainerConfig(solver=JSolverConfig(iter_size=iter_size,
                                                **RECIPE),
                           batch_size=8, seed=22)
    jt = JTrainer(jcfg, jtcfg, donate=False)
    params_np, state_np, _ = jax.device_get(jt.init())
    tt = Trainer(_tcfg(jcfg), _t_trainer_cfg(jtcfg), device="cpu")
    tt.init()
    params, state = params_from_numpy(params_np, state_np, "cpu")
    opt = tt.solver.init(params)
    jp, js, jo = jt.init()
    j_loss, t_loss = [], []
    for step, b in enumerate(_batches(jcfg, 5, 8, iter_size)):
        jp, js, jo, loss = jt._train_step(
            jp, js, jo, {k: jnp.asarray(v) for k, v in b.items()},
            jnp.asarray(step), jax.random.PRNGKey(step))
        j_loss.append(float(loss))
        params, state, opt, loss = tt._train_step(
            params, state, opt, {k: torch.from_numpy(v) for k, v in
                                 b.items()}, step)
        t_loss.append(float(loss))
    return (j_loss, jp, js, jo), (t_loss, params, state, opt)


def test_train_step_losses_match(five_steps):
    (j_loss, *_), (t_loss, *_) = five_steps
    np.testing.assert_allclose(t_loss, j_loss, **STEP_TOL)


# Leaves whose gradient is rounding noise, whose sign neither package
# defines, so AdaDelta moves them by its normalized step in whatever
# direction the noise points (the same in both packages only by chance):
#  * every conv bias feeds a train-mode BN that subtracts the batch mean,
#    so its true gradient is 0; the BN running means follow those biases;
#  * with W = 0 (the recipe's init) the sim map is constant at step 0, so
#    both BNs see constant inputs and divide by sqrt(1e-9): the step-0
#    gradients of the BN shifts are amplified roundings too.
# Such a leaf is held to the band AdaDelta allows: both packages' moves,
# each at most steps * lr_mult(2) * ADADELTA_STEP in size.
NOISE = ("conv0.b", "conv1.b")
NOISE_AT_ZERO_W = NOISE + ("bn0.shift", "bn1.shift")
BAND = 2 * 5 * 2 * ADADELTA_STEP


def test_train_step_params_and_state_match(five_steps, request):
    (_, jp, js, jo), (_, tp, ts, to) = five_steps
    zeros = "zeros" in request.node.callspec.id
    _assert_trees_close(tp, jp, NOISE_AT_ZERO_W if zeros else NOISE, BAND,
                        **STEP_TOL)
    _assert_trees_close(ts, js, ("bn0.mean", "bn1.mean"), BAND, **STEP_TOL)
    if not zeros:
        # at W = 0 the accumulators of g^2 hold the step-0 gradients, up
        # to 1e6 in size and amplified roundings in their low digits
        _assert_trees_close(to, jo, tuple(f"{k}.{n}" for k in ("h", "h2")
                                          for n in NOISE), BAND, **STEP_TOL)


def test_scan_train_steps_is_the_step_loop():
    cfg = _tcfg(_small_cfg(sim_weight_init="xavier"))
    tt = Trainer(cfg, TrainerConfig(solver=SolverConfig(**RECIPE),
                                    batch_size=4), device="cpu")
    p0, s0, o0 = tt.init()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg, 3, 4, 1)]
    p, s, o = p0, s0, o0
    losses = []
    for i, b in enumerate(batches):
        p, s, o, loss = tt._train_step(p, s, o, b, 5 + i)
        losses.append(loss)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    pf, sf, of, lf = tt.scan_train_steps(p0, s0, o0, stacked, 5)
    assert torch.equal(lf, torch.stack(losses))
    for a, b in zip(tree_leaves({"p": p, "s": s, "o": o}),
                    tree_leaves({"p": pf, "s": sf, "o": of})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("args", [(0, 4, 100, [10]), (7, 4, 100, [10]),
                                  (9, 50, 100, [10, 4]), (3, 8, 2, [5]),
                                  (10, 3, 100, [10]), (5, 6, 100, [])])
def test_plan_chunk_matches_jax(args):
    assert Trainer._plan_chunk(*args) == JTrainer._plan_chunk(*args)


def test_epoch_batches_shuffle_and_wrap():
    cfg = _tcfg(_small_cfg())
    data = {"label": torch.arange(10), "question": torch.arange(10)[:, None]}
    tt = Trainer(cfg, TrainerConfig(batch_size=4), device="cpu")
    passes = [[b["label"] for b in tt._epoch_batches(data, e)]
              for e in (0, 0, 1)]
    assert [len(b) for b in passes[0]] == [4, 4, 4]    # last one wrapped
    seen = torch.cat(passes[0])
    assert sorted(seen[:10].tolist()) == list(range(10))
    assert torch.equal(seen[10:], seen[:2])            # wraps to the start
    assert all(torch.equal(a, b) for a, b in zip(passes[0], passes[1]))
    assert not torch.equal(torch.cat(passes[0]), torch.cat(passes[2]))
    skipped = list(tt._epoch_batches(data, 0, start_batch=1))
    assert all(torch.equal(a["label"], b)
               for a, b in zip(skipped, passes[0][1:]))
    t2 = Trainer(cfg, TrainerConfig(batch_size=2, solver=SolverConfig(
        iter_size=2)), device="cpu")
    first = next(t2._epoch_batches(data, 0))
    assert first["label"].shape == (2, 2) and first["question"].shape == \
        (2, 2, 1)


# -------------------------------------------------------------------- fit
def _fit_data():
    xml, w2v = synthetic_corpus(n_questions=10, answers_per_q=6, seed=1)
    splits, info = prepare_trec_qa(xml, xml, xml, w2v, q_len=12, a_len=10)
    return splits, info


def _fixed_order(data, batch_size, to_tensor):
    """One numpy batch order for every pass (wrap-around included)."""
    n = len(data["label"])
    order = np.random.default_rng(7).permutation(n)
    reps = np.concatenate([order] * (batch_size // n + 2))
    return [{k: to_tensor(v[reps[s: s + batch_size]]) for k, v in
             data.items() if k != "group"} for s in range(0, n, batch_size)]


class _JaxFit(JTrainer):
    def _epoch_batches(self, data, epoch_key, start_batch=0):
        yield from _fixed_order(data, self.cfg.batch_size,
                                jnp.asarray)[start_batch:]


def _torch_fit_trainer(params_np, state_np):
    class TorchFit(Trainer):
        def init(self, *, pretrained=None):
            super().init(pretrained=pretrained)      # builds the solver
            params, state = params_from_numpy(params_np, state_np,
                                              self.device)
            return params, state, self.solver.init(params)

        def _epoch_batches(self, data, epoch_index, start_batch=0):
            host = {k: v.cpu().numpy() for k, v in data.items()}
            yield from _fixed_order(host, self.cfg.batch_size,
                                    torch.from_numpy)[start_batch:]
    return TorchFit


# The fit runs with a xavier W.  From the recipe's W = 0 the first steps'
# scores are near-ties that rounding noise orders (on this corpus: dev MAP
# 0.560 vs 0.593 after step 0), so the two packages' dev MAP, and
# with it the early stop, part at once; the train-step tests above cover
# W = 0.
@pytest.fixture(scope="module", params=[1, 2], ids=lambda p: f"patience{p}")
def two_fits(request):
    splits, info = _fit_data()
    jcfg = _small_cfg(vocab_size=info["vocab_size"], embed_dim=50,
                      sim_weight_init="xavier")
    jtcfg = JTrainerConfig(solver=JSolverConfig(**RECIPE), max_iter=60,
                           batch_size=10, test_interval=5,
                           train_loss_record_interval=1,
                           early_stop_patience=request.param, seed=22)
    jt = _JaxFit(jcfg, jtcfg, donate=False)
    params_np, state_np, _ = jax.device_get(
        jt.init(pretrained=info["pretrained"]))
    stops = {"jax": [], "torch": []}
    jh = jt.fit(splits["train"], splits["dev"], test_data=splits["test"],
                pretrained=info["pretrained"],
                callback=stops["jax"].append)
    tt = _torch_fit_trainer(params_np, state_np)(
        _tcfg(jcfg), _t_trainer_cfg(jtcfg), device="cpu")
    th = tt.fit(splits["train"], splits["dev"], test_data=splits["test"],
                pretrained=info["pretrained"],
                callback=stops["torch"].append)
    return jh, th, stops, tt, splits


def test_fit_history_matches_jax(two_fits):
    jh, th, stops, _, _ = two_fits
    # the last recorded loss is the early-stop (or last) iteration
    assert len(th["train_loss"]) == len(jh["train_loss"])
    assert th["steps"] == jh["steps"]
    assert th["best_step"] == jh["best_step"]
    assert [c["step"] for c in stops["torch"]] == \
        [c["step"] for c in stops["jax"]]
    for key in ("train_loss", "dev_map", "dev_mrr", "dev_auc", "test_map",
                "test_mrr", "test_auc"):
        np.testing.assert_allclose(th[key], jh[key], **STEP_TOL, err_msg=key)
    np.testing.assert_allclose(th["best_dev_map"], jh["best_dev_map"],
                               **STEP_TOL)
    _assert_trees_close(th["params"], jh["params"], **STEP_TOL)
    _assert_trees_close(th["state"], jh["state"], **STEP_TOL)


@pytest.mark.parametrize("donate", [False, True])
def test_fit_with_donate_matches_jax(two_fits, donate):
    """``Trainer(donate=)`` as the JAX package takes it: the port never
    consumes its inputs, so either value trains as JAX's ``fit`` does."""
    jh, _, _, tt, splits = two_fits
    th = type(tt)(tt.model_cfg, tt.cfg, device="cpu", donate=donate).fit(
        splits["train"], splits["dev"], test_data=splits["test"])
    assert th["steps"] == jh["steps"]
    assert th["best_step"] == jh["best_step"]
    for key in ("train_loss", "dev_map", "test_map"):
        np.testing.assert_allclose(th[key], jh[key], **STEP_TOL, err_msg=key)
    _assert_trees_close(th["params"], jh["params"], **STEP_TOL)
    _assert_trees_close(th["state"], jh["state"], **STEP_TOL)


def test_fit_stops_early_by_epoch_patience(two_fits, request):
    _, th, *_ = two_fits
    # 60 rows at batch 10: 6 steps an epoch.  The epoch counter starts at
    # -1, so steps 0 and 1 both cross an "epoch" boundary (the driver's
    # quirk), then 6, 12, 18.  Patience 1 stops at step 1; patience 2,
    # with the best dev MAP at step 5, waits out 6 and 12 and stops at 18.
    patience = int(request.node.callspec.id[-1])
    assert len(th["train_loss"]) == {1: 2, 2: 19}[patience]
    assert th["best_step"] == {1: 0, 2: 5}[patience]


def test_evaluate_matches_numpy_metrics(two_fits):
    _, th, _, tt, splits = two_fits
    from mms_answer_selection_tpu_torch import metrics as TM
    res = tt.evaluate(th["params"], th["state"], splits["test"])
    s = res["prob"][:, 1].astype(np.float64)
    labels, groups = splits["test"]["label"], splits["test"]["group"]
    np.testing.assert_allclose(res["map"], TM.mean_average_precision(
        s, labels, groups), atol=1e-5)
    np.testing.assert_allclose(res["mrr"], TM.mean_reciprocal_rank(
        s, labels, groups), atol=1e-5)
    assert res["prob"].shape == (len(labels), 2)


@pytest.mark.parametrize("together", [False, True])
def test_checkpoint_paths_raise(together, tmp_path):
    """resume_from, weights and snapshot_dir train (each alone, from a
    snapshot of a short run); resume_from and weights together raise."""
    splits, info = _fit_data()
    cfg = _tcfg(_small_cfg(vocab_size=info["vocab_size"], embed_dim=50))
    snap = Trainer(cfg, TrainerConfig(max_iter=3, batch_size=10,
                                      test_interval=2, snapshot_interval=2,
                                      snapshot_dir=str(tmp_path)),
                   device="cpu")
    first = snap.fit(splits["train"], splits["dev"],
                     pretrained=info["pretrained"])
    assert sorted(os.listdir(tmp_path)) == ["qa_iter_0", "qa_iter_2"]
    tt = Trainer(cfg, TrainerConfig(max_iter=5, batch_size=10,
                                    test_interval=2), device="cpu")
    kws = [dict(resume_from=str(tmp_path)),
           dict(weights=str(tmp_path / "qa_iter_2"))]
    if together:
        with pytest.raises(ValueError, match="mutually exclusive"):
            tt.fit(splits["train"], splits["dev"], **kws[0], **kws[1])
        return
    resumed, tuned = (tt.fit(splits["train"], splits["dev"], **kw)
                      for kw in kws)
    assert resumed["steps"] == [0, 2, 4]                 # 0, 2 from the meta
    assert resumed["dev_map"][:2] == first["dev_map"]
    assert tuned["steps"] == [0, 2, 4]
    assert np.all(np.isfinite(tuned["train_loss"]))


def test_fit_is_reproducible_with_dropout():
    splits, info = _fit_data()
    cfg = dataclasses.replace(_tcfg(_small_cfg(
        vocab_size=info["vocab_size"], embed_dim=50)), sim_dropout=0.1,
        fc1_dropout=0.5)
    tcfg = TrainerConfig(solver=SolverConfig(**RECIPE), max_iter=12,
                         batch_size=10, test_interval=6,
                         train_loss_record_interval=1)
    runs = [Trainer(cfg, tcfg, device="cpu").fit(
        splits["train"], splits["dev"], pretrained=info["pretrained"])
        for _ in range(2)]
    assert runs[0]["train_loss"] == runs[1]["train_loss"]
    assert np.all(np.isfinite(runs[0]["train_loss"]))
    p = params_to_numpy(runs[0]["params"], runs[0]["state"])[0]
    assert not np.array_equal(p["embed"]["w"][: len(info["pretrained"])],
                              info["pretrained"])         # embeddings moved


def _small_fit(**tkw):
    splits, info = _fit_data()
    cfg = _tcfg(_small_cfg(vocab_size=info["vocab_size"], embed_dim=50,
                           sim_weight_init="xavier"))
    tcfg = TrainerConfig(**(dict(solver=SolverConfig(**RECIPE), max_iter=23,
                                 batch_size=10, test_interval=5,
                                 train_loss_record_interval=1,
                                 early_stop_patience=50) | tkw))
    return Trainer(cfg, tcfg, device="cpu"), splits, info


def test_fit_steps_are_scan_train_steps():
    # fit's steps are scan_train_steps over its batch stream: 60 rows at
    # batch 10 are 6 steps a pass, pass p shuffled by epoch index p
    tt, splits, info = _small_fit()
    hist = tt.fit(splits["train"], splits["dev"],
                  pretrained=info["pretrained"])
    assert hist["steps"] == [0, 5, 10, 15, 20]
    train = tt._full_batch({k: v for k, v in splits["train"].items()
                            if k != "group"})
    batches = [b for p in range(4) for b in tt._epoch_batches(train, p)]
    stacked = {k: torch.stack([b[k] for b in batches[:23]])
               for k in batches[0]}
    *_, losses = tt.scan_train_steps(*tt.init(pretrained=info["pretrained"]),
                                     stacked, 0)
    assert losses.tolist() == hist["train_loss"]


def test_fit_stops_on_sigint_when_handling_signals():
    import os
    import signal

    tt, splits, info = _small_fit()
    before = signal.getsignal(signal.SIGINT)

    def interrupt(event):
        if event["step"] == 10:
            os.kill(os.getpid(), signal.SIGINT)

    hist = tt.fit(splits["train"], splits["dev"],
                  pretrained=info["pretrained"], callback=interrupt,
                  handle_signals=True)
    assert hist["steps"] == [0, 5, 10]
    assert len(hist["train_loss"]) == 11          # stopped after step 10
    assert signal.getsignal(signal.SIGINT) == before
