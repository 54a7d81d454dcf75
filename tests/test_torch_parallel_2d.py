"""The port's sharded training past one mesh axis and past two ranks, and
the CLI's multi-rank ``--mesh-dp`` under a launcher, on the CPU against
the JAX package.

Every rank is a process: ``parallel.launch.spawn`` for the sharded steps
(gloo over a file store, ``test_torch_parallel_ranks.py``), ``torchrun
--standalone`` for the CLI.  The JAX side runs on the CPU devices that
``tests/conftest.py`` provides.

What is held, and how closely:
* dp = 2 x tp = 2 (four ranks) and dp = 4 x tp = 2 (eight ranks)
  ``build_sharded_train_step`` against JAX's on the same layout, from
  JAX's init carried over as numpy, dropout off (the packages draw their
  masks from different generators): the losses, the eval step's
  probabilities before and after, every parameter (the tp slices joined),
  the BN state and the solver history within STEP_TOL (rtol 1e-4, atol
  1e-4).  The conv biases, whose true gradient is 0 ahead of a train-mode
  BN, move by rounding noise that each solver normalizes to its own step:
  they, the BN means that follow them and their history are held to that
  step's band (JAX's ``test_parallel.py`` bounds them so).
* dp = 2 x tp = 2 with dropout on against one process: the global batch's
  masks are drawn on a 2-D mesh as one process draws them.
* ``cli train --mesh-dp 2`` and ``cli solve --mesh-dp 2`` (the generic
  ``caffe train``) under ``torchrun --nproc-per-node 2`` against the JAX
  CLI's ``--mesh-dp 2`` over two devices, from one set of initial
  weights: the snapshots within the same tolerances, the history and the
  trec_eval table rank 0 prints within STEP_TOL.
* A global batch that the dp size does not divide is refused, as JAX's
  ``jit(in_shardings=P("dp"))`` refuses it, naming both sizes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.parallel import mesh as JMESH
from mms_answer_selection_tpu.parallel import train_step as JTS
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    make_solver as j_make_solver,
)
from mms_answer_selection_tpu_torch.parallel.launch import spawn
from mms_answer_selection_tpu_torch.training import SolverConfig
from test_torch_parallel import (ADADELTA_STEP, NOISE, STEP_TOL, _batches,
                                 _jcfg, _named, _tcfg)

HERE = os.path.dirname(os.path.abspath(__file__))
# the JAX package's test_parallel.py solvers for its dp x tp layouts
SOLVERS = {
    "sgd": dict(solver_type="sgd", base_lr=0.1, momentum=0.9,
                weight_decay=5e-4),
    "adadelta": dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
                     delta=5e-7, weight_decay=5e-4),
    "adam": dict(solver_type="adam", base_lr=0.01, momentum=0.9,
                 delta=1e-8, weight_decay=5e-4)}
STEPS, BATCH = 3, 16


def _noise_band(solver: str, steps: int) -> float:
    """How far a conv bias (lr_mult 2) may part between two layouts after
    ``steps`` steps: each step's update of a rounding-noise gradient, of
    either sign.  AdaDelta's step is lr * sqrt(delta / (1 - momentum)) at
    most for such a gradient, Adam's lr; SGD's is lr times the noise, far
    under STEP_TOL's atol."""
    per = {"adadelta": ADADELTA_STEP, "adam": SOLVERS["adam"]["base_lr"],
           "sgd": STEP_TOL["atol"] / 2}[solver]
    return 2 * 2 * steps * per * 1.05


@pytest.fixture(autouse=True)
def one_thread_a_rank(monkeypatch):
    """Each spawned rank computes on one intra-op thread: eight ranks
    beside the suite's other workers would oversubscribe the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _ranks(fn, world, **kwargs):
    return spawn(f"test_torch_parallel_ranks:{fn}", world, kwargs=kwargs,
                 pythonpath=[HERE], timeout=120, share_device=True)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _joined(ranks, key):
    """The tp slices of dp replica 0 joined along axis 0 where the spec
    splits a leaf; every dp replica must hold the same slices."""
    by_tp = sorted((r for r in ranks if r["dp_rank"] == 0),
                   key=lambda r: r["tp_rank"])
    for r in ranks:
        mine = by_tp[r["tp_rank"]][key]
        for (name, a), (_, b) in zip(_named(r[key]), _named(mine)):
            assert np.array_equal(a, b), (key, name, r["dp_rank"])
    spec = ranks[0]["spec"]

    def join(trees, spec):
        if isinstance(trees[0], dict):
            return {k: join([t[k] for t in trees], spec[k]) for k in trees[0]}
        return torch.cat(trees) if spec else trees[0]

    if key == "opt":
        return {k: join([r[key][k] for r in by_tp], spec)
                for k in by_tp[0][key]}
    return join([r[key] for r in by_tp], spec)


def _held(got, want, band, follows=()):
    """Every leaf within STEP_TOL, the noise leaves (and ``follows``,
    those that move with them) within ``band``."""
    for (name, g), (name2, w) in zip(_named(got), _named(want)):
        assert name == name2
        if name.split(".")[-2] + "." + name.split(".")[-1] in NOISE \
                or name in follows:
            assert np.abs(g - w).max() <= band, (name, np.abs(g - w).max())
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **STEP_TOL)


def _jax_sharded_run(jcfg, solver_kw, dp, tp, batches, eval_batch):
    """JAX's ``build_sharded_train_step`` and ``_eval_step`` on a (dp, tp)
    mesh of the conftest's CPU devices, from its init (a xavier metric)."""
    params, state = JQ.mms_qa_init(jax.random.PRNGKey(0), jcfg)
    solver = j_make_solver(JSolverConfig(**solver_kw),
                           JQ.param_spec(params, jcfg))
    opt = solver.init(params)
    mesh = JMESH.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    evaluate = JTS.build_sharded_eval_step(jcfg, mesh)
    start = (_numpy(params), _numpy(state))
    prob = evaluate(params, state, eval_batch)
    step = JTS.build_sharded_train_step(jcfg, solver, mesh, donate=False)(
        params, state, opt)
    losses = []
    for i, b in enumerate(batches):
        params, state, opt, loss = step(params, state, opt, b,
                                        jnp.asarray(i),
                                        jax.random.PRNGKey(100 + i))
        losses.append(float(loss))
    return {"start": start, "losses": losses, "params": _numpy(params),
            "state": _numpy(state), "opt": _numpy(opt),
            "prob": np.asarray(prob),
            "evaluate": lambda p, s: np.asarray(evaluate(p, s, eval_batch))}


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                           else v) for k, v in b.items()}


def _sharded_equals_jax(solver, dp, tp, steps):
    jcfg = _jcfg(sim_dropout=0.0, fc1_dropout=0.0)
    batches = _batches(steps, BATCH, seed=11)
    want = _jax_sharded_run(jcfg, SOLVERS[solver], dp, tp,
                            [_jax_batch(b) for b in batches],
                            _jax_batch(batches[0]))
    ranks = _ranks("sharded_step", dp * tp, model_cfg=_tcfg(jcfg),
                   solver_cfg=SolverConfig(**SOLVERS[solver]),
                   batch=batches[0], batches=batches, dp=dp, tp=tp,
                   params=want["start"][0], state=want["start"][1])
    assert sorted((r["dp_rank"], r["tp_rank"]) for r in ranks) == [
        (d, t) for d in range(dp) for t in range(tp)]
    assert ranks[0]["spec"]["embed"]["w"] == ("tp",) \
        and ranks[0]["spec"]["sim"]["w"] == ("tp",)
    band = _noise_band(solver, steps)
    params = _joined(ranks, "params")
    # the eval step on the trained weights: JAX's on the port's (eval-mode
    # BN magnifies the conv biases' noise, so each package's own trained
    # weights give probabilities apart by more than STEP_TOL)
    after = want["evaluate"](*jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), (params, ranks[0]["state"])))
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        np.testing.assert_allclose(r["prob"].numpy(), want["prob"],
                                   **STEP_TOL)
        np.testing.assert_allclose(r["prob_after"].numpy(), after,
                                   **STEP_TOL)
    _held(params, want["params"], band)
    _held(ranks[0]["state"], want["state"], band,
          follows=("bn0.mean", "bn1.mean"))
    # SGD's history is its last update; AdaDelta's and Adam's are means of
    # squares (and Adam's h of the gradient itself), as JAX's test bounds
    _held(_joined(ranks, "opt"), want["opt"],
          band if solver == "sgd" else max(1e-6, band ** 2))
    for r in ranks:   # BN state is replicated: every rank holds rank 0's
        for (_, a), (_, b) in zip(_named(r["state"]),
                                  _named(ranks[0]["state"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("solver", ["sgd", "adadelta", "adam"])
def test_dp2_tp2_sharded_step_equals_jax(solver):
    """JAX's ``test_parallel.py:143-160`` layouts at dp x tp: the port's
    four ranks, each with half the embedding rows and one of the two
    measures, take three steps as JAX's 2 x 2 mesh does."""
    _sharded_equals_jax(solver, 2, 2, STEPS)


def test_dp4_tp2_sharded_step_equals_jax():
    """JAX's ``test_parallel.py:84`` layout, dp = 4 x tp = 2 over eight
    ranks (four rows of the batch each), SGD, one step."""
    _sharded_equals_jax("sgd", 4, 2, 1)


def test_dp2_tp2_with_dropout_draws_what_one_process_draws():
    """Dropout on: each rank takes its rows of the global batch's masks,
    and both tp ranks of a replica draw the same, so four ranks train as
    one process does."""
    cfg = _tcfg(_jcfg())
    assert cfg.sim_dropout > 0 and cfg.fc1_dropout > 0
    batches = _batches(STEPS, BATCH, seed=12)
    kw = dict(model_cfg=cfg, solver_cfg=SolverConfig(**SOLVERS["adadelta"]),
              batch=batches[0], batches=batches)
    one = _ranks("sharded_step", 1, dp=1, tp=1, **kw)[0]
    ranks = _ranks("sharded_step", 4, dp=2, tp=2, **kw)
    band = _noise_band("adadelta", STEPS)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], **STEP_TOL)
    _held(_joined(ranks, "params"), one["params"], band)
    _held(ranks[0]["state"], one["state"], band,
          follows=("bn0.mean", "bn1.mean"))


@pytest.mark.parametrize("program", ["trainer", "sharded_step"])
def test_batch_the_dp_size_does_not_divide_is_refused_as_jax_refuses(
        program):
    """A global batch of 5 over two dp ranks: JAX's ``jit`` with the batch
    sharded over "dp" refuses it (dimension 0 "should be divisible by 2,
    but it is equal to 5"); so does the port, on every rank, naming both
    sizes, before any step runs."""
    jcfg = _jcfg(sim_dropout=0.0, fc1_dropout=0.0)
    batch = _batches(1, 5, seed=13)[0]
    mesh = JMESH.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    if program == "trainer":
        from mms_answer_selection_tpu.training import (
            Trainer as JTrainer, TrainerConfig as JTrainerConfig)
        from mms_answer_selection_tpu_torch.training import TrainerConfig
        jt = JTrainer(jcfg, JTrainerConfig(batch_size=5), mesh=mesh,
                      donate=False)
        jp, js, jo = jt.init()
        run = lambda: jt._train_step(jp, js, jo, _jax_batch(batch),  # noqa
                                     jnp.asarray(0), jax.random.PRNGKey(0))
        port = dict(fn="trainer_steps", model_cfg=_tcfg(jcfg),
                    trainer_cfg=TrainerConfig(batch_size=5),
                    batches=[batch])
    else:
        params, state = JQ.mms_qa_init(jax.random.PRNGKey(0), jcfg)
        solver = j_make_solver(JSolverConfig(**SOLVERS["sgd"]),
                               JQ.param_spec(params, jcfg))
        step = JTS.build_sharded_train_step(jcfg, solver, mesh)(
            params, state, solver.init(params))
        run = lambda: step(params, state, solver.init(params),  # noqa
                           _jax_batch(batch), jnp.asarray(0),
                           jax.random.PRNGKey(0))
        port = dict(fn="sharded_step", model_cfg=_tcfg(jcfg),
                    solver_cfg=SolverConfig(**SOLVERS["sgd"]), batch=batch,
                    dp=2, tp=1)
    with pytest.raises(ValueError, match="divisible by 2, but it is equal "
                                         "to 5"):
        run()
    with pytest.raises(RuntimeError) as got:
        _ranks(port.pop("fn"), 2, **port)
    text = str(got.value)
    for rank in (0, 1):
        assert f"rank {rank} exited" in text
    assert text.count("ValueError: batch of 5 rows does not split over 2 "
                      "dp ranks") == 2
