"""The meshed programs' capture decision, on the CPU: where a mesh's
programs run as CUDA graph replays (``parallel.mesh.mesh_captures``: the
mesh on the card and every group NCCL) and where they run eagerly (a
gloo mesh, the CPU's), and the replayed ``build_sharded_train_step``'s
bookkeeping, which the CPU runs eagerly on the same static buffers.

The meshed results against the JAX package are ``test_torch_parallel.py``'s
(unchanged here).  Tolerance: bit for bit: the sharded step through its
runner runs the same float32 operations as a direct call of its body, on
the same inputs and the same dropout draws.
"""

import logging

import pytest
import torch
import torch.distributed as dist

from mms_answer_selection_tpu_torch.models import mms_qa as TM
from mms_answer_selection_tpu_torch.parallel import (
    build_sharded_eval_step, build_sharded_train_step, make_mesh)
from mms_answer_selection_tpu_torch.parallel import mesh as TMESH
from mms_answer_selection_tpu_torch.parallel.train_step import (
    loss_and_grads, reduce_grads)
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.training import (
    SolverConfig, Trainer, TrainerConfig)
from mms_answer_selection_tpu_torch.training.graph_solver import GraphSolver
from mms_answer_selection_tpu_torch.training.optim import make_solver
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_graph_solver import MLP, _mlp_feeds, _write

CFG = TM.MMSQAConfig(
    vocab_size=60, embed_dim=8, question_len=10, answer_len=10,
    sim_measures=2, sim_weight_init="xavier", sim_dropout=0.3,
    blocks=(TM.ConvBlock(3, 3, 4, "ave", 2, 2),), fc1_dim=4)


@pytest.fixture
def gloo_mesh():
    """A one-process gloo mesh, its group torn down after (the xdist
    worker goes on to other files)."""
    assert not dist.is_initialized()
    yield make_mesh(devices="cpu")
    dist.destroy_process_group()


def _batch(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"question": torch.randint(0, 60, (n, 10), generator=g),
            "answer": torch.randint(0, 60, (n, 10), generator=g),
            "overlap_feat": torch.rand((n, 2), generator=g),
            "label": torch.randint(0, 2, (n,), generator=g)}


# -------------------------------------------------------- the predicate
class _Mesh:
    device_type = "cuda"
    mesh_dim_names = ("dp", "tp")

    def get_group(self, axis):
        return axis


@pytest.mark.parametrize("backends,want", [
    (("nccl", "nccl", "nccl"), True),
    (("cpu:gloo,cuda:nccl",) * 3, True),
    (("gloo", "gloo", "gloo"), False),
    (("nccl", "nccl", "gloo"), False),
    (("cpu:nccl,cuda:gloo", "nccl", "nccl"), False)])
def test_mesh_captures_only_where_every_group_is_nccl(monkeypatch, backends,
                                                      want):
    """The whole mesh's group, dp's and tp's must all run CUDA tensors'
    collectives over NCCL."""
    by_group = dict(zip((dist.group.WORLD, "dp", "tp"), backends))
    monkeypatch.setattr(dist, "get_backend", lambda g: by_group[g])
    assert TMESH.mesh_captures(_Mesh()) is want
    cpu = _Mesh()
    cpu.device_type = "cpu"
    assert not TMESH.mesh_captures(cpu)


def test_a_gloo_mesh_does_not_capture(gloo_mesh):
    assert not TMESH.mesh_captures(gloo_mesh)


# ---------------------------------------- gloo owners: eager, logged once
def _mesh_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("mesh:")]


def test_gloo_owners_run_eagerly_and_log_once(gloo_mesh, caplog, tmp_path):
    caplog.set_level(logging.INFO, logger="mms_tpu_torch.graphs")
    tr = Trainer(CFG, TrainerConfig(max_iter=4, batch_size=6),
                 mesh=gloo_mesh, device="cpu")
    p, s, o = tr.init()
    batches = {k: torch.stack([v] * 2) for k, v in _batch().items()}
    for step0 in (0, 2):
        tr.scan_train_steps(p, s, o, batches, step0)
    tr._eval_step(*tr.runner.carry[:2], _batch(8, seed=1))
    assert not tr.captures and not tr.runner.captures
    assert not tr.evals.captures and tr.runner.mesh is None
    assert _mesh_lines(caplog) == [
        "mesh: trainer: eager calls (the mesh's cpu collectives are not "
        "captured)"]

    caplog.clear()
    gs = GraphSolver(_write(tmp_path, MLP, max_iter=4, test_iter=2),
                     feeds=_mlp_feeds(),
                     mesh=gloo_mesh, device="cpu")
    gs.step(3)
    gs.test()
    assert not gs.captures and not gs.runner.captures
    assert not gs.forwards.captures
    assert len(_mesh_lines(caplog)) == 1

    caplog.clear()
    params, state = TM.mms_qa_init(CFG, generator=torch.Generator(),
                                   device="cpu")
    eng = QueryEngine(params, CFG, mesh=gloo_mesh, device="cpu",
                      chunk_size=16).build_index(_batch(40)["answer"])
    for _ in range(2):
        eng.query(_batch(3)["question"], k=5)
        eng.query_rerank(state, _batch(3)["question"], k=3, shortlist=8)
    assert not eng._calls.captures and eng._calls.replays == 0
    assert _mesh_lines(caplog) == [
        "mesh: engine: eager calls (the mesh's cpu collectives are not "
        "captured)"]

    caplog.clear()
    solver = make_solver(SolverConfig(), TM.param_spec(params, CFG))
    step = build_sharded_train_step(CFG, solver, gloo_mesh)(
        params, state, solver.init(params))
    evaluate = build_sharded_eval_step(CFG, gloo_mesh)
    carry = (params, state, solver.init(params))
    for i in range(2):
        *carry, _ = step(*carry, _batch(), i, torch.Generator())
        evaluate(carry[0], carry[1], _batch())
    assert sorted(_mesh_lines(caplog)) == [
        "mesh: sharded eval step: eager calls (the mesh's cpu collectives "
        "are not captured)",
        "mesh: sharded train step: eager calls (the mesh's cpu collectives "
        "are not captured)"]


def test_only_owners_with_collectives_take_the_mesh(gloo_mesh, monkeypatch):
    """Were the mesh one that captures, the Trainer's chunks would capture
    over it and its eval step without it (the eval runs no collective and
    keys on the carry's addresses; one rank may evaluate alone, as ``cli
    train`` does on its test split).  A meshed call's key holds nothing
    rank-local, so it refuses ``fixed`` addresses, over gloo too."""
    from mms_answer_selection_tpu_torch.training import trainer as TT
    from mms_answer_selection_tpu_torch.utils import graphs

    monkeypatch.setattr(TMESH, "mesh_captures", lambda mesh: True)
    monkeypatch.setattr(TT, "resolve_device", torch.device)  # no card here
    tr = Trainer(CFG, TrainerConfig(), mesh=gloo_mesh, device="cuda")
    assert tr.captures and tr.evals.captures and tr.evals.mesh is None
    meshed = graphs.GraphedCall("cuda", name="meshed", mesh=gloo_mesh)
    assert meshed.captures and meshed.mesh is gloo_mesh
    off = graphs.GraphedCall("cuda", name="off", mesh=gloo_mesh,
                             captures=False)
    assert not off.captures and off.mesh is None
    eager = graphs.GraphedCall("cpu", name="eager", mesh=gloo_mesh)
    x = torch.ones(3)
    assert torch.equal(eager(("f",), lambda t: t * 2, x), x * 2)
    with pytest.raises(ValueError, match="nothing rank-local"):
        eager(("f",), lambda t: t * 2, x, fixed=(x,))
    plain = graphs.GraphedCall("cpu", name="plain")
    assert torch.equal(plain(("f",), lambda t: t + x, x, fixed=(x,)), x * 2)


# --------------------------------------- the sharded step's bookkeeping
def _plain_step(params, state, opt, batch, it, generator, solver):
    """The step's body called directly: no runner, no static buffers."""
    loss, new_state, grads = loss_and_grads(
        TM.mms_qa_apply, params, state, batch, CFG, generator, None)
    grads, loss = reduce_grads(grads, loss, TMESH.shard_context(None))
    gi = iter(grads)
    params, opt = solver.apply(params, tree_map(lambda _: next(gi), params),
                               opt, it)
    return params, new_state, opt, loss


def _clone(trees):
    return [tree_map(torch.clone, t) for t in trees]


def _same(a, b):
    """Whether two trees (or lists of trees) hold the same bits."""
    a, b = (list(t) if isinstance(t, (list, tuple)) else [t] for t in (a, b))
    return all(torch.equal(x, y) for ta, tb in zip(a, b)
               for x, y in zip(tree_leaves(ta), tree_leaves(tb)))


@pytest.mark.parametrize("donate", [True, False])
def test_sharded_step_takes_it_as_int_or_tensor(gloo_mesh, donate):
    """Three steps with dropout: ``it`` an int, a 0-d tensor, and the
    body called directly, give the same bits and leave the caller's
    generator where the direct call leaves it.  ``donate``: the returned
    trees are the static carry (the next call overwrites them) or clones
    (they outlive it)."""
    params, state = TM.mms_qa_init(CFG, generator=torch.Generator(),
                                   device="cpu")
    solver = make_solver(SolverConfig(solver_type="adadelta", base_lr=1.0),
                         TM.param_spec(params, CFG))
    runs = {}
    for how in ("int", "tensor", "plain"):
        carry = _clone((params, state, solver.init(params)))
        step = build_sharded_train_step(CFG, solver, gloo_mesh,
                                        donate=donate)(*carry)
        gen = torch.Generator().manual_seed(5)
        outs = []
        for i in range(3):
            it = torch.tensor(i) if how == "tensor" else i
            if how == "plain":
                *carry, loss = _plain_step(*carry, _batch(seed=i), it, gen,
                                           solver)
            else:
                *carry, loss = step(*carry, _batch(seed=i), it, gen)
            outs.append((_clone(carry), carry, loss))
        runs[how] = outs, gen.get_state()
    for how in ("int", "tensor"):
        outs, state_after = runs[how]
        assert torch.equal(state_after, runs["plain"][1])
        for (kept, _, loss), (want, _, wloss) in zip(outs, runs["plain"][0]):
            assert _same(kept, want) and torch.equal(loss, wloss)
        first, last = outs[0][1][0], outs[-1][1][0]
        shared = tree_leaves(first)[0].data_ptr() == \
            tree_leaves(last)[0].data_ptr()
        assert shared is donate
        assert _same(first, outs[0][0][0]) is not donate
