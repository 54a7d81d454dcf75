"""The plain reference and the traffic generator, held against the port at
small sizes on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from h100_bench import port, traffic
from h100_bench.reference import plain

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(name, **over):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def small(name="v4", **over):
    return config(name, vocab_size=300, **over)


def port_model(cfg):
    return port.model_config(cfg)


def batch_of(cfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    v, w1, w2 = cfg["vocab_size"], cfg["question_len"], cfg["answer_len"]
    return {"question": torch.randint(0, v, (n, w1), generator=g),
            "answer": torch.randint(0, v, (n, w2), generator=g),
            "overlap_feat": torch.rand((n, 2), generator=g),
            "label": torch.randint(0, 2, (n,), generator=g)}


@pytest.mark.parametrize("name,w_init", [("v4", "zeros"), ("v4", "xavier"),
                                         ("v4_wide", "xavier")])
def test_init_draws_the_ports_weights(name, w_init):
    from mms_answer_selection_tpu_torch.models.mms_qa import mms_qa_init

    cfg = small(name, sim_weight_init=w_init)
    want, want_state = mms_qa_init(port_model(cfg),
                                   generator=torch.Generator().manual_seed(7))
    got, got_state = plain.init(cfg, 7, "cpu")
    assert plain.leaves(got).keys() == plain.leaves(want).keys()
    for k, v in plain.leaves(want).items():
        assert torch.equal(plain.leaves(got)[k], v), k
    for k, v in plain.leaves(want_state).items():
        assert torch.equal(plain.leaves(got_state)[k], v), k


@pytest.mark.parametrize("name", ["v4", "v4_wide"])
def test_forward_loss_and_gradients_match_the_port(name):
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        mms_qa_apply, mms_qa_init)

    cfg = small(name, sim_weight_init="xavier")
    mc = port_model(cfg)
    params, state = mms_qa_init(mc, generator=torch.Generator().manual_seed(3))
    batch = batch_of(cfg, 6, 11)
    leaves = plain.leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    out, new_state = mms_qa_apply(params, state, batch, mc, train=True,
                                  generator=torch.Generator().manual_seed(5))
    want = torch.autograd.grad(out["loss"], list(leaves.values()))
    ref_params, ref_state = plain.init(cfg, 3, "cpu")
    ref_leaves = plain.leaves(ref_params)
    for t in ref_leaves.values():
        t.requires_grad_(True)
    loss, logits, ref_new = plain.forward(
        cfg, ref_params, ref_state, batch,
        gen=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(loss, list(ref_leaves.values()))
    assert float(loss.detach()) == pytest.approx(
        float(out["loss"].detach()), rel=1e-6)
    torch.testing.assert_close(logits, out["logits"], rtol=1e-5, atol=1e-6)
    for k, g, w in zip(leaves, got, want):
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-5 * scale, k
    for k, v in plain.leaves(new_state).items():
        torch.testing.assert_close(plain.leaves(ref_new)[k], v.detach(),
                                   rtol=1e-5, atol=1e-7)


def test_adadelta_matches_the_ports_solver():
    from mms_answer_selection_tpu_torch.models.mms_qa import (
        mms_qa_init, param_spec)
    from mms_answer_selection_tpu_torch.training import SolverConfig
    from mms_answer_selection_tpu_torch.training.optim import make_solver

    cfg = small()
    mc = port_model(cfg)
    params, _ = mms_qa_init(mc, generator=torch.Generator().manual_seed(1))
    solver = make_solver(SolverConfig(**cfg["solver"]),
                         param_spec(params, mc))
    opt = solver.init(params)
    g = torch.Generator().manual_seed(2)
    grads = {n: {k: torch.randn(v.shape, generator=g) for k, v in sub.items()}
             for n, sub in params.items()}
    mine = {k: v.clone() for k, v in plain.leaves(params).items()}
    h = {k: torch.zeros_like(v) for k, v in mine.items()}
    h2 = {k: torch.zeros_like(v) for k, v in mine.items()}
    mults = plain.multipliers(params)
    for step in range(3):
        params, opt = solver.apply(params, grads, opt, step)
        plain.adadelta(mine, plain.leaves(grads), h, h2, cfg["solver"], mults)
    for k, v in plain.leaves(params).items():
        torch.testing.assert_close(mine[k], v, rtol=1e-6, atol=1e-9)
    for k, v in plain.leaves(opt["h"]).items():
        torch.testing.assert_close(h[k], v, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("d", [50, 300])
def test_maxsim_matches_the_ports_packing(dtype, d):
    from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

    g = torch.Generator().manual_seed(d)
    q = torch.rand((3, 40, d), generator=g) - 0.5
    c = torch.rand((37, 40, d), generator=g) - 0.5
    w = (torch.rand((4, d, d), generator=g) - 0.5) * 0.1
    if dtype == "bf16":
        want = sk.bilinear_maxsim_scores(sk.project_queries(q, w),
                                         sk.pack_candidate_pool(c))
    else:
        pool, aux = sk.pack_candidate_pool_int8(c)
        want = sk.bilinear_maxsim_scores_int8(*sk.project_queries_int8(q, w),
                                              pool, aux)
    got = plain.maxsim_scores(q, lambda a, b: c[a:b], 37, w, dtype, block=8)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_int4_scores_part_from_int8():
    g = torch.Generator().manual_seed(0)
    q = torch.rand((2, 40, 50), generator=g) - 0.5
    c = torch.rand((20, 40, 50), generator=g) - 0.5
    w = (torch.rand((4, 50, 50), generator=g) - 0.5) * 0.1
    s8 = plain.maxsim_scores(q, lambda a, b: c[a:b], 20, w, "int8", 20)
    s4 = plain.maxsim_scores(q, lambda a, b: c[a:b], 20, w, "int4", 20)
    gap = float((s8 - s4).abs().max() / s8.std())
    assert gap > 0.01


SHAPES = {"vocab_size": 1000, "maxlen": 40, "zipf_s": 1.0, "oov_rate": 0.12,
          "q_tokens": [5, 10], "a_tokens": [10, 28], "pool": 500, "batch": 7,
          "query_batches": 3, "train_pairs": 400, "dev_pairs": 55,
          "train_answers": [30, 50], "dev_answers": [12, 24],
          "pos_frac": 0.25}


def test_sentences_are_center_padded_corpus_lengths():
    ids = traffic.candidates(2**31 + 5, SHAPES, "cpu")
    pad, unknown = 999, 998
    assert ids.shape == (500, 40) and ids.dtype == torch.int32
    real = ids != pad
    n = real.sum(1)
    assert int(n.min()) >= 10 and int(n.max()) <= 28
    first = real.int().argmax(1)
    assert torch.equal(first, (40 - n) // 2)
    # the real tokens are contiguous
    assert torch.equal(real.sum(1), real.int().cumsum(1).amax(1))
    assert 0.05 < float((ids[real] == unknown).float().mean()) < 0.2
    q = traffic.query_batches(2**31 + 5, SHAPES, "cpu")
    nq = (q != pad).sum(-1)
    assert q.shape == (3, 7, 40) and int(nq.min()) >= 5 and int(nq.max()) <= 10


def test_the_seed_fixes_the_inputs():
    a = traffic.candidates(123, SHAPES, "cpu")
    assert torch.equal(a, traffic.candidates(123, SHAPES, "cpu"))
    assert not torch.equal(a, traffic.candidates(124, SHAPES, "cpu"))
    assert not torch.equal(a[:, :1].flatten(),
                           traffic.query_batches(123, SHAPES, "cpu")[0, :, 0])


def test_word_ids_follow_zipf():
    ids = traffic.candidates(9, dict(SHAPES, pool=20000, oov_rate=0.0),
                             "cpu")
    real = ids[ids != 999]
    counts = torch.bincount(real.long(), minlength=998).double()
    # rank 1 about twice rank 2, ten times rank 10
    assert 1.7 < float(counts[0] / counts[1]) < 2.3
    assert 7 < float(counts[0] / counts[9]) < 13


def test_corpus_has_the_asked_sizes_and_groups():
    data = traffic.corpus(77, SHAPES, "cpu")
    train, dev = data["train"], data["dev"]
    assert len(train["label"]) == 400 and len(dev["label"]) == 55
    for split in (train, dev):
        assert split["question"].dtype == np.int32
        assert split["label"].dtype == np.int32
        assert split["overlap_feat"].shape == (len(split["label"]), 2)
        groups = np.unique(split["group"])
        for gid in groups:   # one question a group, at least one positive
            rows = split["group"] == gid
            assert len(np.unique(split["question"][rows], axis=0)) == 1
            assert split["label"][rows].sum() >= 1
    sizes = np.bincount(dev["group"])
    assert sizes[:-1].min() >= 12 and sizes.max() <= 24


def test_model_config_is_the_ports_v4():
    from mms_answer_selection_tpu_torch.models.mms_qa import V4, V4_WIDE

    assert port.model_config(config("v4")) == dataclasses.replace(
        V4, vocab_size=50000)
    assert port.model_config(config("v4_wide")) == dataclasses.replace(
        V4_WIDE, vocab_size=50000)
