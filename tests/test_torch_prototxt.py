"""The port's prototxt module against the JAX package's, on the same text.

The JAX module's body is free of JAX and the port keeps it line for line,
so every result must be equal: parsed dicts, upgraded dicts, emitted
text, and the typed configs (compared field by field through
``dataclasses.asdict``, the classes being each package's own).  No
tolerance: the comparisons are exact.
"""

import dataclasses
from pathlib import Path

import pytest

from mms_answer_selection_tpu.models import caption_image as JC
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.models import pair_image as JP
from mms_answer_selection_tpu.training import TrainerConfig as JTrainerConfig
from mms_answer_selection_tpu.utils import prototxt as J
from mms_answer_selection_tpu_torch.models import caption_image as TC
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.models import pair_image as TP
from mms_answer_selection_tpu_torch.training import TrainerConfig
from mms_answer_selection_tpu_torch.utils import prototxt as T

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "generic_mlp"

SOLVER = """
train_net: "run/train.prototxt"
test_net: "run/dev.prototxt"
test_iter: 23
test_interval: 100
base_lr: 1.0
display: 20
max_iter: 40001
lr_policy: "fixed"
momentum: 0.95
weight_decay: 0.0005
snapshot: 100
snapshot_prefix: "run/qa"
random_seed: 22
delta: 5e-07
type: "AdaDelta"
"""

LEGACY_SOLVER = """
solver_type: RMSPROP
rms_decay: 0.9
lr_policy: "multistep"
stepvalue: 10
stepvalue: 20
gamma: 0.5
iter_size: 3
clip_gradients: 5
regularization_type: "L1"
"""

V0_NET = """
name: "v0"
layers { layer { name: "ip" type: "innerproduct" num_output: 4
  weight_filler { type: "xavier" } blobs_lr: 1 blobs_lr: 2
  weight_decay: 1 weight_decay: 0 } bottom: "data" top: "ip" }
layers { layer { name: "relu" type: "relu" } bottom: "ip" top: "ip" }
"""

NESTED = """
# a NetStateRule block, like FilterNet consumes
layer { name: "data" include { phase: TRAIN } }
layer { name: "loss" loss_weight: 1.0 top: "l" top: "m" }
solver_type: ADADELTA
stepvalue: 10
stepvalue: 20
s: "with \\"quotes\\" inside"
neg: -3
sci: 1e-3
"""

TEXTS = {"solver": SOLVER, "legacy_solver": LEGACY_SOLVER, "v0": V0_NET,
         "nested": NESTED}
TEXTS.update({p.stem: p.read_text() for p in EXAMPLES.glob("*.prototxt")})


def _v4(mod, **kw):
    return dataclasses.replace(mod.V4, vocab_size=77, **kw)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_upgrade_and_emit_match(name):
    text = TEXTS[name]
    d = T.parse_prototxt(text)
    assert d == J.parse_prototxt(text)
    assert T.upgrade_net_prototxt(T.parse_prototxt(text)) == \
        J.upgrade_net_prototxt(J.parse_prototxt(text))
    assert T.upgrade_solver_prototxt(T.parse_prototxt(text)) == \
        J.upgrade_solver_prototxt(J.parse_prototxt(text))
    assert T.emit_prototxt(d) == J.emit_prototxt(J.parse_prototxt(text))


def test_v1_and_v0_upgrades_reach_modern_layers():
    v1 = T.upgrade_net_prototxt(T.parse_prototxt(
        (EXAMPLES / "legacy_v1.prototxt").read_text()))
    assert [la["type"] for la in v1["layer"]] == [
        "InnerProduct", "ReLU", "SoftmaxWithLoss"]
    assert v1["layer"][0]["param"] == J.upgrade_net_prototxt(
        J.parse_prototxt((EXAMPLES / "legacy_v1.prototxt").read_text())
    )["layer"][0]["param"]
    v0 = T.upgrade_net_prototxt(T.parse_prototxt(V0_NET))
    assert [la["type"] for la in v0["layer"]] == ["InnerProduct", "ReLU"]


def test_unbalanced_braces_rejected_by_both():
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.parse_prototxt("a { b: 1")


@pytest.mark.parametrize("text", [SOLVER, LEGACY_SOLVER,
                                  (EXAMPLES / "solver.prototxt").read_text()])
def test_solver_and_trainer_configs_match(text):
    tc, tex = T.solver_config_from_prototxt(text)
    jc, jex = J.solver_config_from_prototxt(text)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tex == jex
    tt = T.trainer_config_from_prototxt(text, snapshot_dir="x")
    jt = J.trainer_config_from_prototxt(text, snapshot_dir="x")
    assert isinstance(tt, TrainerConfig)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert T.solver_prototxt_from_config(tt) == \
        J.solver_prototxt_from_config(jt)


@pytest.mark.parametrize("solver_type", ["adadelta", "adam", "rmsprop",
                                         "sgd"])
def test_solver_prototxt_from_config_matches(solver_type):
    from mms_answer_selection_tpu.training import SolverConfig as JS
    from mms_answer_selection_tpu_torch.training import SolverConfig as TS

    kw = dict(solver_type=solver_type, base_lr=0.5, iter_size=2,
              lr_policy="step", stepsize=7)
    t = TrainerConfig(solver=TS(**kw), max_iter=9, snapshot_prefix="p")
    j = JTrainerConfig(solver=JS(**kw), max_iter=9, snapshot_prefix="p")
    assert T.solver_prototxt_from_config(t, train_net="a", test_net="b") \
        == J.solver_prototxt_from_config(j, train_net="a", test_net="b")


@pytest.mark.parametrize("variant", ["V3", "V4", "V4_2", "V5", "V4_WIDE"])
@pytest.mark.parametrize("phase", ["train", "eval"])
def test_net_prototxt_round_trip_matches(variant, phase):
    t_cfg = dataclasses.replace(getattr(TQ, variant), vocab_size=77)
    j_cfg = dataclasses.replace(getattr(JQ, variant), vocab_size=77)
    text = T.net_prototxt_from_config(t_cfg, batch_size=13, phase=phase)
    assert text == J.net_prototxt_from_config(j_cfg, batch_size=13,
                                              phase=phase)
    back = T.model_config_from_net_prototxt(text, question_len=40)
    assert isinstance(back, TQ.MMSQAConfig)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        J.model_config_from_net_prototxt(text, question_len=40))


def test_pair_and_caption_image_prototxts_match():
    t_pi, j_pi = TP.PairImageConfig(), JP.PairImageConfig()
    text = T.pair_image_net_prototxt(t_pi)
    assert text == J.pair_image_net_prototxt(j_pi)
    back = T.pair_image_config_from_net_prototxt(text)
    assert isinstance(back, TP.PairImageConfig)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        J.pair_image_config_from_net_prototxt(text))
    t_ci, j_ci = TC.CaptionImageConfig(), JC.CaptionImageConfig()
    text = T.caption_image_net_prototxt(t_ci)
    assert text == J.caption_image_net_prototxt(j_ci)
    back = T.caption_image_config_from_net_prototxt(text)
    assert isinstance(back, TC.CaptionImageConfig)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        J.caption_image_config_from_net_prototxt(text))
