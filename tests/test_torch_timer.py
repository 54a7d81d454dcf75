"""``utils/timer.py`` against the JAX package's: the same keys from
``benchmark``, the same stage names and per-stage keys from
``stage_times`` and ``stage_times_fwd_bwd``, and a trace file from
``trace``.  Times are the host's here and are checked only for being
non-negative and finite."""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.utils import timer as JT
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.utils import timer as TT

JCFG = JQ.MMSQAConfig(
    vocab_size=200, embed_dim=8, question_len=12, answer_len=12,
    sim_measures=2, sim_weight_init="xavier",
    blocks=(JQ.ConvBlock(3, 3, 4, "ave", 2, 2),
            JQ.ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
TCFG = TQ.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TQ.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})


@pytest.fixture(scope="module")
def model():
    jp, js = JQ.mms_qa_init(jax.random.PRNGKey(0), JCFG)
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(0)
    batch = {"question": rng.integers(0, 200, (8, 12)).astype(np.int32),
             "answer": rng.integers(0, 200, (8, 12)).astype(np.int32),
             "overlap_feat": rng.random((8, 2)).astype(np.float32),
             "label": rng.integers(0, 2, (8,)).astype(np.int32)}
    tp, ts = params_from_numpy(jp, js, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jp, js, batch, tp, ts, tb


def _finite_ms(x):
    return isinstance(x, float) and math.isfinite(x) and x >= 0


def test_benchmark_keys_equal_jax():
    want = JT.benchmark(jax.jit(lambda x: x + 1), np.ones(3, np.float32),
                        iters=3, warmup=1)
    got = TT.benchmark(lambda x: x + 1, torch.ones(3), iters=3, warmup=1)
    assert set(got) == set(want)
    assert got["iters"] == want["iters"] == 3
    assert got["min_s"] <= got["p50_s"] <= got["p95_s"]


def test_stage_times_fwd_bwd_keys_equal_jax(model):
    jp, js, batch, tp, ts, tb = model
    want = JT.stage_times_fwd_bwd(jp, js, batch, JCFG, iters=1)
    got = TT.stage_times_fwd_bwd(tp, ts, tb, TCFG, iters=1)
    assert list(got) == list(want) == ["embed", "sim_cross", "conv_block0",
                                       "conv_block1", "head"]
    for name in want:
        assert set(got[name]) == set(want[name]) \
            == {"forward_ms", "backward_ms"}
        assert all(_finite_ms(v) for v in got[name].values())


def test_stage_times_keys_equal_jax(model):
    jp, js, batch, tp, ts, tb = model
    want = JT.stage_times(jp, js, batch, JCFG, iters=1)
    got = TT.stage_times(tp, ts, tb, TCFG, iters=1)
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name])


def test_stage_times_leave_the_inputs_alone(model):
    _, _, _, tp, ts, tb = model
    before = {k: v.clone() for k, v in tp["sim"].items()}
    TT.stage_times_fwd_bwd(tp, ts, tb, TCFG, iters=1)
    assert all(torch.equal(before[k], tp["sim"][k]) for k in before)
    assert not any(v.requires_grad for v in tp["sim"].values())


def test_trace_writes_a_chrome_trace(model, tmp_path):
    _, _, _, tp, ts, tb = model
    path = tmp_path / "trace.json"
    with TT.trace(str(path)):
        TQ.mms_qa_apply(tp, ts, tb, TCFG, train=False)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
