"""The port's chunk runner (``training/dispatch.py``), the counterpart of
the JAX trainer's fused ``scan_train_steps`` dispatch, on the CPU.

On the card a chunk of K steps is one CUDA graph replay; on the CPU the
same body runs as eager steps on the same static buffers, so these tests
hold the body, its in-place carry and the loop around it:

* the learning rate and Adam's correction from a 0-d tensor step (what a
  captured chunk computes on the device) equal those from the int step,
  exactly: the same float32 formulas of the same float32 step;
* K = 1 and 3 steps, iter_size 1 and 2, dropout on, through the runner
  equal K ``_train_step`` calls bit for bit (the same step code on the
  same values, the generators re-seeded as the eager step seeds its own);
* ``fit``'s best params are copies taken at the best eval, and its
  per-step loss records at K = 4 equal K = 1's bit for bit;
* ``fit(steps_per_dispatch=4)`` against the JAX package's, dropout off,
  within ``tests/test_torch_training.py``'s stated fit tolerance (STEP_TOL,
  its reasons there);
* the launch-tally arithmetic on a stub.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    TrainerConfig as JTrainerConfig,
)
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
    learning_rate,
    make_solver,
)
from mms_answer_selection_tpu_torch.training.dispatch import (
    ChunkRunner,
    _origin,
    add_tally,
    record_tally,
)
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_training import (
    RECIPE,
    STEP_TOL,
    _assert_trees_close,
    _batches,
    _fit_data,
    _JaxFit,
    _small_cfg,
    _t_trainer_cfg,
    _tcfg,
    _torch_fit_trainer,
)

POLICIES = [dict(lr_policy="fixed"),
            dict(lr_policy="step", stepsize=2, gamma=0.5),
            dict(lr_policy="exp", gamma=0.9),
            dict(lr_policy="inv", gamma=0.1, power=0.75),
            dict(lr_policy="multistep", stepvalues=(1, 3), gamma=0.3),
            dict(lr_policy="multistep", gamma=0.3),
            dict(lr_policy="poly", max_iter=10, power=2.0),
            dict(lr_policy="sigmoid", gamma=-0.5, stepsize=2)]


def _same(a, b) -> bool:
    """Equal leaves (a tuple's items are its subtrees)."""
    if isinstance(a, tuple):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ------------------------------------------------------- a step as a tensor
@pytest.mark.parametrize("policy", POLICIES,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in
                                                c.items()))
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_learning_rate_of_a_tensor_step_is_the_int_steps(policy, dtype):
    cfg = SolverConfig(base_lr=0.05, **policy)
    for step in (0, 1, 2, 3, 7, 40000):
        got = learning_rate(cfg, torch.tensor(step, dtype=dtype))
        want = learning_rate(cfg, step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert torch.equal(got, want), (step, got, want)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_adam_of_a_tensor_step_is_the_int_steps(dtype):
    g = torch.Generator().manual_seed(0)
    params = {"a": {"w": torch.randn((4, 3), generator=g)},
              "b": {"v": torch.randn((5,), generator=g)}}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    for policy in POLICIES:
        solver = make_solver(SolverConfig(solver_type="adam", base_lr=0.05,
                                          **policy))
        opt = solver.init(params)
        for step in (0, 3, 11):
            want = solver.apply(params, grads, opt, step)
            got = solver.apply(params, grads, opt,
                               torch.tensor(step, dtype=dtype))
            assert _same(got, want), (policy, step)


# ------------------------------------------------------------ the body
def _dropout_cfg():
    return _tcfg(_small_cfg(sim_weight_init="xavier", sim_dropout=0.1,
                            fc1_dropout=0.5))


def _trainer(iter_size, **kw):
    cfg = _dropout_cfg()
    tcfg = TrainerConfig(solver=SolverConfig(iter_size=iter_size, **RECIPE),
                         batch_size=4, seed=9, **kw)
    return Trainer(cfg, tcfg, device="cpu"), cfg


def _torch_batches(cfg, n, iter_size, seed=3):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in _batches(cfg, n, 4, iter_size, seed)]


@pytest.mark.parametrize("iter_size", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_runner_body_is_the_step_loop_bit_for_bit(k, iter_size):
    """Two chunks of K through one runner (the second on the carry the
    first left in its static buffers) against 2K ``_train_step`` calls."""
    tt, cfg = _trainer(iter_size)
    carry = tt.init()
    before = tree_map(torch.clone, dict(enumerate(carry)))
    batches = _torch_batches(cfg, 2 * k, iter_size)
    p, s, o = carry
    want = []
    for i, b in enumerate(batches):
        p, s, o, loss = tt._train_step(p, s, o, b, 5 + i)
        want.append(loss)
    runner = ChunkRunner(tt, carry)
    got = runner.run(batches[:k], 5).clone()
    got = torch.cat([got, runner.run(batches[k:], 5 + k)])
    assert torch.equal(got, torch.stack(want))
    assert _same(runner.carry, (p, s, o))
    assert _same(dict(enumerate(carry)), before)   # inputs untouched
    assert runner.replays == 0 and not runner.captures    # the CPU: eager
    assert [(c["k"], c["replays"]) for c in runner.stats()] == [(k, 0)]


def test_runner_takes_stacked_batches_and_loads_a_carry():
    tt, cfg = _trainer(1)
    carry = tt.init()
    batches = _torch_batches(cfg, 3, 1)
    stacked = {n: torch.stack([b[n] for b in batches]) for n in batches[0]}
    runner = ChunkRunner(tt, carry)
    from_list = runner.run(batches, 0).clone()
    after_list = runner.snapshot()
    assert runner.fits(carry)
    runner.load(carry)
    assert _same(runner.carry, carry)
    assert torch.equal(runner.run(stacked, 0), from_list)
    assert _same(runner.carry, after_list)
    assert not runner.fits((carry[0], {}, carry[2]))


def test_scan_train_steps_keeps_its_graphs_and_returns_copies():
    tt, cfg = _trainer(1)
    p0, s0, o0 = tt.init()
    batches = _torch_batches(cfg, 4, 1)
    stacked = {n: torch.stack([b[n] for b in batches]) for n in batches[0]}
    first = tt.scan_train_steps(p0, s0, o0, stacked, 0)
    runner = tt.runner
    second = tt.scan_train_steps(*first[:3], stacked, 4)
    assert tt.runner is runner                  # the carry fit: kept
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(dict(enumerate(first[:3]))),
        tree_leaves(dict(enumerate(runner.carry)))))
    p, s, o = p0, s0, o0
    for i in range(8):
        p, s, o, _ = tt._train_step(p, s, o, batches[i % 4], i)
    assert _same(second[:3], (p, s, o))


# ------------------------------------------------------------------- fit
class _ScriptedEvals(Trainer):
    """Dev MAP from a script, the params at each eval kept."""
    script = (0.3, 0.9, 0.2, 0.4, 0.5)

    def _record_eval(self, it, params, state, dev_batch, test_batch,
                     history):
        super()._record_eval(it, params, state, dev_batch, test_batch,
                             history)
        self.at_eval[it] = tree_map(torch.clone, params)
        dev_map = self.script[len(self.at_eval) - 1]
        history["dev_map"][-1] = dev_map
        return dev_map


@pytest.mark.parametrize("k", [1, 4])
def test_fit_keeps_the_params_of_its_best_eval(k):
    splits, info = _fit_data()
    cfg = _tcfg(_small_cfg(vocab_size=info["vocab_size"], embed_dim=50,
                           sim_weight_init="xavier"))
    tt = _ScriptedEvals(cfg, TrainerConfig(
        solver=SolverConfig(**RECIPE), max_iter=21, batch_size=10,
        test_interval=5, early_stop_patience=50), device="cpu")
    tt.at_eval = {}
    hist = tt.fit(splits["train"], splits["dev"],
                  pretrained=info["pretrained"], steps_per_dispatch=k)
    assert hist["steps"] == [0, 5, 10, 15, 20] and hist["best_step"] == 5
    assert _same(hist["params"], tt.at_eval[5])
    assert not _same(hist["params"], tt.at_eval[20])


@pytest.mark.parametrize("iter_size", [1, 2])
def test_fit_chunks_record_the_losses_of_single_steps(iter_size):
    splits, info = _fit_data()
    cfg = dataclasses.replace(_tcfg(_small_cfg(
        vocab_size=info["vocab_size"], embed_dim=50)), sim_dropout=0.1,
        fc1_dropout=0.5)
    tcfg = TrainerConfig(solver=SolverConfig(iter_size=iter_size, **RECIPE),
                         max_iter=19, batch_size=10, test_interval=6,
                         train_loss_record_interval=1)
    runs = {k: Trainer(cfg, tcfg, device="cpu").fit(
        splits["train"], splits["dev"], pretrained=info["pretrained"],
        steps_per_dispatch=k) for k in (1, 4)}
    assert runs[4]["train_loss"] == runs[1]["train_loss"]
    assert len(runs[1]["train_loss"]) == 19
    assert runs[4]["steps"] == runs[1]["steps"] == [0, 6, 12, 18]
    assert runs[4]["dev_map"] == runs[1]["dev_map"]
    assert _same(runs[4]["params"], runs[1]["params"])


def test_fit_in_chunks_of_4_matches_jax_in_chunks_of_4():
    splits, info = _fit_data()
    jcfg = _small_cfg(vocab_size=info["vocab_size"], embed_dim=50,
                      sim_weight_init="xavier")
    jtcfg = JTrainerConfig(solver=JSolverConfig(**RECIPE), max_iter=23,
                           batch_size=10, test_interval=10,
                           train_loss_record_interval=1,
                           early_stop_patience=50, seed=22)
    jt = _JaxFit(jcfg, jtcfg, donate=False)
    params_np, state_np, _ = jax.device_get(
        jt.init(pretrained=info["pretrained"]))
    jh = jt.fit(splits["train"], splits["dev"], test_data=splits["test"],
                pretrained=info["pretrained"], steps_per_dispatch=4)
    tt = _torch_fit_trainer(params_np, state_np)(
        _tcfg(jcfg), _t_trainer_cfg(jtcfg), device="cpu")
    th = tt.fit(splits["train"], splits["dev"], test_data=splits["test"],
                pretrained=info["pretrained"], steps_per_dispatch=4)
    assert th["steps"] == jh["steps"] == [0, 10, 20]
    assert len(th["train_loss"]) == len(jh["train_loss"]) == 23
    assert th["best_step"] == jh["best_step"]
    for key in ("train_loss", "dev_map", "dev_mrr", "dev_auc", "test_map",
                "test_mrr", "test_auc"):
        np.testing.assert_allclose(th[key], jh[key], **STEP_TOL, err_msg=key)
    _assert_trees_close(th["params"], jh["params"], **STEP_TOL)
    _assert_trees_close(th["state"], jh["state"], **STEP_TOL)


# ---------------------------------------------------------- launch tally
def test_a_capture_counts_no_launch_and_a_replay_counts_its_tally():
    counts = {"pair_maps_fwd": 7, "pair_maps_bwd_qa": 0, "maxsim_int8": 2}

    def capture():                      # what a 3-step body launches
        for _ in range(3):
            counts["pair_maps_fwd"] += 1
            counts["pair_maps_bwd_qa"] += 1

    tally = record_tally(counts, capture)
    assert tally == {"pair_maps_fwd": 3, "pair_maps_bwd_qa": 3}
    assert counts == {"pair_maps_fwd": 7, "pair_maps_bwd_qa": 0,
                      "maxsim_int8": 2}
    for _ in range(5):                  # five replays
        add_tally(counts, tally)
    assert counts == {"pair_maps_fwd": 22, "pair_maps_bwd_qa": 15,
                      "maxsim_int8": 2}


def test_a_failed_capture_takes_its_counts_back_and_names_the_line():
    counts = {"pair_maps_fwd": 1}

    def capture():
        counts["pair_maps_fwd"] += 1
        try:
            torch.zeros(2).item()       # the host sync a capture refuses
        finally:
            raise RuntimeError("capture invalidated")

    with pytest.raises(RuntimeError, match="invalidated") as info:
        record_tally(counts, capture)
    assert counts == {"pair_maps_fwd": 1}
    where = _origin(info.value)
    assert "test_torch_dispatch.py" in where and ".item()" in where
