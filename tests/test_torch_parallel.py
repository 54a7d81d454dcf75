"""The port's parallel slice (``parallel/``, ``Trainer(mesh=)``,
``GraphSolver(mesh=)``, ``QueryEngine(mesh=)``) on the CPU: every rank is a
process (``parallel.launch.spawn``: gloo, a file store in a scratch
directory, a timeout), running ``test_torch_parallel_ranks.py``.

What is held, and how closely:
* ``make_mesh``'s checks and ``params_pspec``'s rule equal the JAX
  package's on the same shapes.
* dp = 2 against the port's dp = 1, and against JAX's ``Trainer`` on a
  2-device mesh (dropout off), for AdaDelta and SGD: losses and params
  within STEP_TOL (rtol 1e-4, atol 1e-4), as ``test_torch_training.py``
  holds one device to JAX; the conv biases, whose gradient is rounding
  noise ahead of a train-mode BN, to AdaDelta's band there.
* tp = 2 against tp = 1: losses, the joined slices and the eval step's
  probabilities within STEP_TOL.
* A 2-rank engine's top-k: ids equal to the one-process engine's and
  JAX's meshed engine's wherever the scores are apart by more than the
  tolerance; values within 1e-6 of the one-process engine's (on the CPU
  the plain scorers' float32 sums depend on the pool's size; the card's
  kernels score a candidate alone, and ``chip_smoke.py`` holds them bit
  for bit).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.parallel import mesh as JMESH
from mms_answer_selection_tpu.serve import QueryEngine as JEngine
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    Trainer as JTrainer,
    TrainerConfig as JTrainerConfig,
)
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.parallel import mesh as TMESH
from mms_answer_selection_tpu_torch.parallel import multihost
from mms_answer_selection_tpu_torch.parallel.dryrun import dryrun_multichip
from mms_answer_selection_tpu_torch.parallel.launch import spawn
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.training import SolverConfig, \
    TrainerConfig
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
ADADELTA_STEP = (5e-7 / 0.05) ** 0.5
NOISE = ("conv0.b", "conv1.b")
RECIPE = dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
              delta=5e-7, weight_decay=5e-4)
SGD = dict(solver_type="sgd", base_lr=0.05, momentum=0.9, weight_decay=5e-4)


def _ranks(fn, world, **kwargs):
    # the ranks compute on the CPU; on a host with a card they may share it
    return spawn(f"test_torch_parallel_ranks:{fn}", world, kwargs=kwargs,
                 pythonpath=[HERE], timeout=120, share_device=True)


def _jcfg(**kw):
    return dataclasses.replace(JQ.V4, **(dict(
        vocab_size=200, embed_dim=8, question_len=12, answer_len=12,
        sim_measures=2, sim_weight_init="xavier",
        blocks=(JQ.ConvBlock(3, 3, 4, "ave", 2, 2),
                JQ.ConvBlock(3, 3, 4, "ave", 3, 1)),
        fc1_dim=4) | kw))


def _tcfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["blocks"] = tuple(TQ.ConvBlock(**dataclasses.asdict(b))
                             for b in jcfg.blocks)
    return TQ.MMSQAConfig(**fields)


def _batches(n_steps, n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"question": rng.integers(0, 200, (n, 12)).astype(np.int64),
             "answer": rng.integers(0, 200, (n, 12)).astype(np.int64),
             "overlap_feat": rng.random((n, 2)).astype(np.float32),
             "label": (rng.random(n) < 0.4).astype(np.int64)}
            for _ in range(n_steps)]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _named(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], np.asarray(tree.detach().cpu().numpy()
                                     if torch.is_tensor(tree) else tree))]


def _trees_close(got, want, band):
    for (name, g), (name2, w) in zip(_named(got), _named(want)):
        assert name == name2
        if name in NOISE:
            assert np.abs(g - w).max() <= band, name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **STEP_TOL)


# ------------------------------------------------------------------- mesh
class _Mesh:
    """The two facts ``params_pspec`` reads of a (dp, tp) mesh."""
    mesh_dim_names = ("dp", "tp")

    def __init__(self, dp, tp):
        self._shape = (dp, tp)

    def size(self, i=None):
        return self._shape[i]


@pytest.mark.parametrize("vocab,measures,tp", [(200, 2, 2), (200, 4, 2),
                                               (201, 3, 2), (200, 2, 1),
                                               (200, 4, 4), (200, 2, 4)])
def test_params_pspec_rule_equals_jax(vocab, measures, tp):
    jcfg = _jcfg(vocab_size=vocab, sim_measures=measures)
    jp, _ = JQ.mms_qa_init(jax.random.PRNGKey(0), jcfg)
    want = JMESH.params_pspec(jp, JMESH.make_mesh(
        dp=1, tp=tp, devices=jax.devices()[:tp]))
    tp_params, _ = params_from_numpy(jax.tree.map(np.asarray, jp), {}, "cpu")
    got = TMESH.params_pspec(tp_params, _Mesh(1, tp))
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert got == want


@pytest.fixture
def one_process_group():
    """A one-process group for the in-process mesh checks, torn down after
    (the xdist worker goes on to other files)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_checks_equal_jax(one_process_group):
    dev1 = jax.devices()[:1]
    mesh = TMESH.make_mesh(devices="cpu")
    assert TMESH.mesh_shape(mesh) == dict(JMESH.make_mesh(devices=dev1).shape)
    assert mesh.mesh_dim_names == ("dp", "tp")
    for kw in ({"tp": 2}, {"dp": 2, "tp": 1}, {"dp": 1, "tp": 3}):
        with pytest.raises(ValueError) as want:
            JMESH.make_mesh(devices=dev1, **kw)
        with pytest.raises(ValueError) as got:
            TMESH.make_mesh(devices="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_ivf_refuses_a_meshed_engine(one_process_group):
    cfg = _tcfg(_jcfg())
    params, _ = TQ.mms_qa_init(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu")
    cand = np.random.default_rng(0).integers(0, 200, (40, 12))
    eng = QueryEngine(params, cfg, mesh=TMESH.make_mesh(devices="cpu"),
                      device="cpu").build_index(cand)
    with pytest.raises(ValueError, match="single-device"):
        eng.build_ivf(n_clusters=4)
    with pytest.raises(ValueError, match="single-device"):
        eng.add_candidates(cand[:2])


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.host_shard() == (0, 1)


def test_initialize_explicit_wiring_failure_propagates(tmp_path,
                                                       one_process_group):
    with pytest.raises(Exception, match="bogus"):  # no such rendezvous
        multihost.initialize("bogus://nowhere", 1, 0, backend="gloo")
    assert not dist.is_initialized()
    multihost.initialize("file://" + str(tmp_path / "store"), 1, 0,
                         backend="gloo")
    assert dist.is_initialized() and dist.get_world_size() == 1
    with pytest.raises(RuntimeError, match="one-process group"):
        multihost.initialize("file://" + str(tmp_path / "other"), 2, 0)


class _Cards:
    """``torch.cuda`` as a host with ``n`` cards shows it; records the
    cards made current and, through ``init_process_group``, what was
    current when each group was made."""

    def __init__(self, monkeypatch, n):
        self.current, self.calls = None, []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "set_device", self._set)
        monkeypatch.setattr(dist, "init_process_group", self._init)

    def _set(self, index):
        self.current = torch.device("cuda", index).index

    def _init(self, backend, **kw):
        self.calls.append((backend, self.current, kw.get("rank")))


@pytest.mark.parametrize("local, rank, cards, want", [
    (None, 0, 4, 0), (None, 5, 4, 1), (None, 3, 1, 0), ("2", 7, 4, 2)])
def test_each_rank_binds_its_own_card(monkeypatch, local, rank, cards, want):
    """``LOCAL_RANK`` where the launcher set it, else the rank modulo the
    host's cards."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_RANK", local)
    c = _Cards(monkeypatch, cards)
    assert TMESH.local_device_index(rank) == want
    assert TMESH.bind_device(rank) == torch.device("cuda", want)
    assert c.current == want


@pytest.mark.parametrize("wiring", ["explicit", "launcher"])
def test_initialize_binds_the_card_before_the_group(monkeypatch, wiring):
    """torchrun's environment, or explicit wiring: process 3 of 4 on a
    2-card host drives card 1, made current before the group exists."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    c = _Cards(monkeypatch, 2)
    if wiring == "explicit":
        multihost.initialize("localhost:1", 4, 3, backend="nccl")
        assert c.calls == [("nccl", 1, 3)]
    else:
        for k, v in (("MASTER_ADDR", "localhost"), ("WORLD_SIZE", "4"),
                     ("RANK", "3"), ("LOCAL_RANK", "1")):
            monkeypatch.setenv(k, v)
        multihost.initialize(backend="nccl")
        assert c.calls == [("nccl", 1, None)]


def test_spawn_shares_a_card_only_when_asked(monkeypatch):
    _Cards(monkeypatch, 1)
    with pytest.raises(ValueError, match="share_device"):
        spawn("test_torch_parallel_ranks:local_rank", 2)
    with pytest.raises(ValueError, match="NCCL"):
        spawn("test_torch_parallel_ranks:local_rank", 2, backend="nccl",
              share_device=True)


def test_spawn_gives_each_rank_its_card(monkeypatch):
    """On a 2-card host rank r is told card r (its ``LOCAL_RANK``); the
    ranks here compute on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert spawn("test_torch_parallel_ranks:local_rank", 2,
                 pythonpath=[HERE], timeout=120) == ["0", "1"]


@pytest.mark.parametrize("rows", [(3, 3), (3, 2)])
def test_global_batch_from_local(rows):
    res = _ranks("multihost_checks", 2, rows=list(rows))
    for r, out in enumerate(res):
        assert out["shard"] == (r, 2)
        assert out["mesh"] == {"dp": 2, "tp": 1}
        if rows[0] == rows[1]:
            kind, x = out["local"]
            assert kind == "LocalBatch" and x.shape == (3, 2)
            assert torch.all(x == r)
        else:
            assert "different local batch sizes" in out["error"]


# --------------------------------------------------------------------- dp
@pytest.fixture(scope="module", params=["adadelta", "sgd"])
def dp_runs(request):
    """Three steps at global batch 8: JAX's Trainer on a 2-device mesh, the
    port's Trainer over 1 and over 2 ranks, all from JAX's init."""
    solver = RECIPE if request.param == "adadelta" else SGD
    jcfg = _jcfg(sim_dropout=0.0, fc1_dropout=0.0)
    jtcfg = JTrainerConfig(solver=JSolverConfig(**solver), batch_size=8)
    jt = JTrainer(jcfg, jtcfg, mesh=JMESH.make_mesh(
        tp=1, devices=jax.devices()[:2]), donate=False)
    jp, js, jo = jt.init()
    p0, s0 = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    batches = _batches(3, 8)
    j_loss = []
    for i, b in enumerate(batches):
        jp, js, jo, loss = jt._train_step(
            jp, js, jo, {k: jnp.asarray(v.astype(np.int32)
                                        if v.dtype == np.int64 else v)
                         for k, v in b.items()},
            jnp.asarray(i), jax.random.PRNGKey(i))
        j_loss.append(float(loss))
    tcfg = _tcfg(jcfg)
    ttcfg = TrainerConfig(solver=SolverConfig(**solver), batch_size=8)
    kw = dict(model_cfg=tcfg, trainer_cfg=ttcfg, batches=batches, params=p0,
              state=s0)
    return {"jax": (j_loss, jp, js), "dp1": _ranks("trainer_steps", 1, **kw),
            "dp2": _ranks("trainer_steps", 2, **kw),
            "band": 2 * 3 * 2 * (ADADELTA_STEP if solver is RECIPE
                                 else 1.0)}


def test_dp2_equals_dp1(dp_runs):
    one, two = dp_runs["dp1"][0], dp_runs["dp2"]
    for rank in two:
        np.testing.assert_allclose(rank["losses"], one["losses"], **STEP_TOL)
        _trees_close(rank["params"], one["params"], dp_runs["band"])
        _trees_close(rank["state"], one["state"], dp_runs["band"])
    # the ranks hold one replica
    for a, b in zip(tree_leaves(two[0]["params"]),
                    tree_leaves(two[1]["params"])):
        assert torch.equal(a, b)


def test_dp2_equals_jax_meshed_trainer(dp_runs):
    j_loss, jp, js = dp_runs["jax"]
    two = dp_runs["dp2"][0]
    np.testing.assert_allclose(two["losses"], j_loss, **STEP_TOL)
    _trees_close(two["params"], jax.tree.map(np.asarray, jp),
                 dp_runs["band"])
    bn_means = {"bn0.mean", "bn1.mean"}  # follow the noisy conv biases
    for (name, g), (_, w) in zip(_named(two["state"]),
                                 _named(jax.tree.map(np.asarray, js))):
        if name not in bn_means:
            np.testing.assert_allclose(g, w, err_msg=name, **STEP_TOL)


def test_dp2_with_dropout_draws_what_dp1_draws():
    cfg = _tcfg(_jcfg())
    assert cfg.sim_dropout > 0 and cfg.fc1_dropout > 0
    kw = dict(model_cfg=cfg, trainer_cfg=TrainerConfig(
        solver=SolverConfig(**RECIPE), batch_size=8),
        batches=_batches(3, 8, seed=5))
    one = _ranks("trainer_steps", 1, **kw)[0]
    two = _ranks("trainer_steps", 2, **kw)[0]
    np.testing.assert_allclose(two["losses"], one["losses"], **STEP_TOL)
    _trees_close(two["params"], one["params"], 2 * 3 * 2 * ADADELTA_STEP)


def test_dp2_with_micro_batches_splits_the_sample_axis():
    """iter_size 2: each batch carries a leading micro-batch axis, and the
    ranks split axis 1."""
    cfg = _tcfg(_jcfg(sim_dropout=0.0, fc1_dropout=0.0))
    batches = [{k: v.reshape((2, 8) + v.shape[1:]) for k, v in b.items()}
               for b in _batches(2, 16, seed=9)]
    kw = dict(model_cfg=cfg, trainer_cfg=TrainerConfig(
        solver=SolverConfig(iter_size=2, **RECIPE), batch_size=8),
        batches=batches)
    one = _ranks("trainer_steps", 1, **kw)[0]
    two = _ranks("trainer_steps", 2, **kw)[0]
    np.testing.assert_allclose(two["losses"], one["losses"], **STEP_TOL)
    _trees_close(two["params"], one["params"], 2 * 2 * 2 * ADADELTA_STEP)


def test_graph_solver_dp2_equals_dp1():
    net = ('layer { name: "d" type: "Input" top: "x" top: "label" } '
           'layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h" '
           'inner_product_param { num_output: 6 weight_filler { type: '
           '"xavier" } } } '
           'layer { name: "bn" type: "BN" bottom: "h" top: "hb" } '
           'layer { name: "relu" type: "ReLU" bottom: "hb" top: "hb" } '
           'layer { name: "drop" type: "Dropout" bottom: "hb" top: "hd" '
           'dropout_param { dropout_ratio: 0.3 } } '
           'layer { name: "ip2" type: "InnerProduct" bottom: "hd" top: "y" '
           'inner_product_param { num_output: 3 weight_filler { type: '
           '"xavier" } } } '
           'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" '
           'bottom: "label" top: "loss" }')
    solver = (f'net_param {{ {net} }} base_lr: 0.1 momentum: 0.9 '
              f'max_iter: 10 random_seed: 3')
    rng = np.random.default_rng(0)
    feeds = {"d": {"x": rng.normal(size=(64, 5)).astype(np.float32),
                   "label": rng.integers(0, 3, (64,)).astype(np.float32),
                   "batch_size": 8}}
    kw = dict(solver_text=solver, feeds=feeds, steps=4)
    one = _ranks("graph_solver_steps", 1, **kw)[0]
    for rank in _ranks("graph_solver_steps", 2, **kw):
        np.testing.assert_allclose(rank["losses"], one["losses"], **STEP_TOL)
        for a, b in zip(tree_leaves(rank["params"]),
                        tree_leaves(one["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)
        for a, b in zip(tree_leaves(rank["state"]),
                        tree_leaves(one["state"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **STEP_TOL)


# --------------------------------------------------------------------- tp
@pytest.mark.parametrize("solver", ["adadelta", "sgd"])
def test_tp2_equals_tp1(solver):
    cfg = _tcfg(_jcfg(sim_dropout=0.0, fc1_dropout=0.0))
    kw = dict(model_cfg=cfg, solver_cfg=SolverConfig(
        **(RECIPE if solver == "adadelta" else SGD)),
        batch=_batches(1, 8, seed=7)[0], steps=2)
    one = _ranks("sharded_step", 1, dp=1, tp=1, **kw)[0]
    two = _ranks("sharded_step", 2, dp=1, tp=2, **kw)
    assert two[0]["spec"]["embed"]["w"] == ("tp",) \
        and two[0]["spec"]["sim"]["w"] == ("tp",)
    by_rank = sorted(two, key=lambda r: r["tp_rank"])
    joined = {k: {kk: (torch.cat([r["params"][k][kk] for r in by_rank])
                       if two[0]["spec"][k][kk] else by_rank[0]["params"][k][kk])
                  for kk in v} for k, v in one["params"].items()}
    band = 2 * 2 * 2 * (ADADELTA_STEP if solver == "adadelta" else 1.0)
    for rank in two:
        np.testing.assert_allclose(rank["losses"], one["losses"], **STEP_TOL)
        np.testing.assert_allclose(rank["prob"].numpy(), one["prob"].numpy(),
                                   **STEP_TOL)
    _trees_close(joined, one["params"], band)
    # a sharded leaf differs between the ranks; a replicated one does not
    assert not torch.equal(by_rank[0]["params"]["embed"]["w"],
                           by_rank[1]["params"]["embed"]["w"])
    assert torch.equal(by_rank[0]["params"]["fc2"]["w"],
                       by_rank[1]["params"]["fc2"]["w"])


def test_dp2_tp1_sharded_step_equals_one_device():
    cfg = _tcfg(_jcfg())
    kw = dict(model_cfg=cfg, solver_cfg=SolverConfig(**RECIPE),
              batch=_batches(1, 8, seed=8)[0], steps=2)
    one = _ranks("sharded_step", 1, dp=1, tp=1, **kw)[0]
    for rank in _ranks("sharded_step", 2, dp=2, tp=1, **kw):
        np.testing.assert_allclose(rank["losses"], one["losses"], **STEP_TOL)
        np.testing.assert_allclose(rank["prob"].numpy(), one["prob"].numpy(),
                                   **STEP_TOL)
        _trees_close(rank["params"], one["params"],
                     2 * 2 * 2 * ADADELTA_STEP)


# ------------------------------------------------------------------ serve
@pytest.fixture(scope="module")
def serve_case():
    jcfg = _jcfg(vocab_size=64, embed_dim=16, question_len=6, answer_len=6)
    params, _ = JQ.mms_qa_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.3 * rng.normal(
        size=x.shape).astype(np.float32), params)
    cand = rng.integers(0, 64, (300, 6)).astype(np.int32)
    cand[7] = cand[100]          # exact ties across the two shards
    cand[150] = cand[3]
    q = rng.integers(0, 64, (5, 6)).astype(np.int32)
    return jcfg, params, cand, q


def _assert_topk_agrees(tv, ti, jv, ji, rtol=1e-5):
    tv, ti, jv, ji = (np.asarray(x) for x in (tv, ti, jv, ji))
    assert tv.shape == jv.shape and ti.shape == ji.shape
    tol = rtol * np.abs(jv).max(axis=1, keepdims=True)
    assert np.all(np.abs(tv - jv) <= tol)
    gaps = np.abs(np.diff(jv, axis=1))
    sep = gaps > tol
    pinned = np.concatenate([sep[:, :1], sep[:, 1:] & sep[:, :-1],
                             sep[:, -1:]], axis=1)
    np.testing.assert_array_equal(ti[pinned], ji[pinned])


@pytest.mark.parametrize("pool_dtype,chunk", [("bf16", 1000), ("bf16", 64),
                                              ("int8", 1000), ("int4", 64)])
def test_sharded_engine_topk(serve_case, pool_dtype, chunk):
    jcfg, params, cand, q = serve_case
    tcfg = _tcfg(jcfg)
    dead = [5, 200]
    res = _ranks("engine_topk", 2, params=params, model_cfg=tcfg, cand=cand,
                 queries=q, k=10, pool_dtype=pool_dtype, chunk_size=chunk,
                 remove=dead)
    tp, _ = params_from_numpy(params, {}, "cpu")
    eng = QueryEngine(tp, tcfg, pool_dtype=pool_dtype, chunk_size=chunk,
                      device="cpu").build_index(cand)
    eng.remove_candidates(dead)
    want_v, want_i = eng.query(torch.as_tensor(q), k=10)
    for r in res:
        assert torch.equal(r["idx"], res[0]["idx"])
        assert torch.equal(r["idx"], want_i)
        np.testing.assert_allclose(r["vals"].numpy(), want_v.numpy(),
                                   rtol=1e-6, atol=0)
        assert not set(r["idx"].flatten().tolist()) & set(dead)
    if pool_dtype != "int4":
        jeng = JEngine(params, jcfg, mesh=jax.sharding.Mesh(
            np.asarray(jax.devices()[:2]), ("c",)),
            pool_dtype=jnp.bfloat16 if pool_dtype == "bf16" else "int8",
            interpret=True).build_index(cand)
        jeng.remove_candidates(dead)
        jv, ji = jeng.query(q, k=10)
        _assert_topk_agrees(res[0]["vals"], res[0]["idx"], jv, ji)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8", "int4"])
def test_four_rank_split_pool_uneven_equals_one_process(serve_case,
                                                        pool_dtype):
    """configs[3]'s layout past two ranks: 299 rows (which do not divide
    by four) split over four ranks, every dtype int4 included, give one
    process's top-10 (ids exactly, scores to 1e-6 on the CPU), and the
    JAX package's engine over a four-device mesh agrees."""
    jcfg, params, cand, q = serve_case
    tcfg = _tcfg(jcfg)
    cand = cand[:299]
    res = _ranks("engine_topk", 4, params=params, model_cfg=tcfg, cand=cand,
                 queries=q, k=10, pool_dtype=pool_dtype, chunk_size=64)
    tp, _ = params_from_numpy(params, {}, "cpu")
    want_v, want_i = QueryEngine(tp, tcfg, pool_dtype=pool_dtype,
                                 chunk_size=64, device="cpu").build_index(
        cand).query(torch.as_tensor(q), k=10)
    for r in res:
        assert torch.equal(r["idx"], want_i)
        np.testing.assert_allclose(r["vals"].numpy(), want_v.numpy(),
                                   rtol=1e-6, atol=0)
    jv, ji = JEngine(params, jcfg, mesh=jax.sharding.Mesh(
        np.asarray(jax.devices()[:4]), ("c",)),
        pool_dtype={"bf16": jnp.bfloat16}.get(pool_dtype, pool_dtype),
        interpret=True).build_index(cand).query(q, k=10)
    _assert_topk_agrees(res[0]["vals"], res[0]["idx"], jv, ji)


def test_sharded_merge_keeps_lax_top_k_order():
    """Equal scores from two ranks go lower global index first, and -0.0
    sorts below +0.0, bit for bit through the gather."""
    for r in _ranks("merge_ties", 2):
        assert r["idx"].tolist() == [[0, 10, 1, 12, 11, 2]]
        bits = r["vals"].view(torch.int32)[0].tolist()
        assert bits[-2:] == [0, -2**31]          # +0.0, then -0.0
        assert r["vals"].tolist() == [[1.0, 1.0, 0.5, 0.5, 0.0, -0.0]]


def test_split_index_reloads_only_onto_its_rank(serve_case, tmp_path):
    jcfg, params, cand, q = serve_case
    tcfg = _tcfg(jcfg)
    res = _ranks("engine_save_load", 2, params=params, model_cfg=tcfg,
                 cand=cand, queries=q, root=str(tmp_path))
    for r in res:
        for a, b in zip(r["before"], r["after"]):
            assert torch.equal(a, b)
        assert 1 not in r["after"][1].flatten().tolist()
    tp, _ = params_from_numpy(params, {}, "cpu")
    with pytest.raises(ValueError, match="packed for 2 shard"):
        QueryEngine(tp, tcfg, pool_dtype="int8", device="cpu").load_index(
            res[0]["path"])


def test_dryrun_multichip():
    dryrun_multichip(2)
