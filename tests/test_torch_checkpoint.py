"""The port's checkpoints against the JAX package's, on CPU: the msgpack
codec against ``flax.serialization`` (bytes and restored trees), a
checkpoint written by either package read by the other, ``copy_matching``
and ``latest_checkpoint`` against JAX's, and ``fit`` resumed from a
snapshot against the uninterrupted run.

Tolerance: none.  The codec must give flax's bytes for the same bundle,
a checkpoint must come back leaf for leaf with the bits it was saved
with, and a resumed ``fit`` must repeat the uninterrupted run bit for bit
(losses, history, params, BN state): on the CPU every step is a fixed
function of the seed and the step.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    TrainerConfig as JTrainerConfig,
    make_solver as j_make_solver,
)
from mms_answer_selection_tpu.training import checkpoint as JC
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.data import (
    prepare_trec_qa,
    synthetic_corpus,
)
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
)
from mms_answer_selection_tpu_torch.training import checkpoint as TC
from mms_answer_selection_tpu_torch.utils import msgpack_codec
from mms_answer_selection_tpu_torch.utils.tree import tree_leaves

RECIPE = dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
              delta=5e-7, weight_decay=5e-4)


def _jax_bundle(cfg=JQ.V4, seed=0):
    """A JAX model's params, BN state and AdaDelta state as numpy, plus
    the scalars and lists a checkpoint meets (numpy scalars, ints, floats,
    None, nested lists)."""
    params, state = JQ.mms_qa_init(jax.random.PRNGKey(seed), cfg)
    opt = j_make_solver(JSolverConfig(**RECIPE),
                        JQ.param_spec(params, cfg)).init(params)
    bundle = jax.device_get({"params": params, "state": state,
                             "opt_state": opt})
    bundle = jax.tree.map(np.asarray, bundle)
    bundle["extra"] = {"count": np.int64(7), "scale": np.float32(0.5),
                       "steps": [0, 100, -3, 2**40], "lr": 1.0,
                       "none": None, "flag": True,
                       "nested": [[1.5, -2], {"b": 2, "a": 1}]}
    return bundle


def _same(a, b):
    """Equal trees: the same structure, leaf types and bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return type(a) is type(b) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return type(a) is type(b) and a == b


# -------------------------------------------------------------------- codec
@pytest.mark.parametrize("cfg", [JQ.V4, JQ.V4_WIDE], ids=["V4", "V4_WIDE"])
def test_codec_bytes_equal_flax(cfg):
    bundle = _jax_bundle(dataclasses.replace(cfg, vocab_size=300))
    data = msgpack_codec.packb(bundle)
    assert data == serialization.msgpack_serialize(bundle)
    assert _same(msgpack_codec.unpackb(data),
                 serialization.msgpack_restore(data))


def test_codec_chunks_large_arrays_as_flax(monkeypatch):
    # a patched MAX_CHUNK_SIZE chunks the embedding table, the sim metric
    # and the conv weights, each into several chunks (more than ten for
    # the table, so the chunk keys' order is their index order)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 2048)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 2048)
    bundle = _jax_bundle()
    bundle["big"] = np.arange(3000, dtype=np.int32)   # a top-level leaf
    data = msgpack_codec.packb(bundle)
    assert data == serialization.msgpack_serialize(bundle)
    assert b"__msgpack_chunked_array__" in data
    restored = msgpack_codec.unpackb(data)
    assert _same(restored, serialization.msgpack_restore(data))
    assert _same(restored["params"], bundle["params"])


@pytest.mark.parametrize("value", [
    {}, [], 0, -1, -32, -33, 127, 128, 255, 256, 65535, 65536, 2**32,
    -129, -2**15 - 1, -2**31 - 1, 2**64 - 1, -2**63, 3.25, float("inf"),
    "", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, b"\x00" * 70000,
    list(range(16)), list(range(70000)), {str(i): i for i in range(16)},
    np.zeros((0,), np.float64), np.ones((2, 3, 4), np.int8),
    np.arange(5, dtype=np.uint16), np.float64(2.5), np.int32(-4),
    np.bool_(True)], ids=lambda v: type(v).__name__)
def test_codec_value_forms_equal_flax(value):
    tree = {"v": value}
    data = msgpack_codec.packb(tree)
    assert data == serialization.msgpack_serialize(tree)
    assert _same(msgpack_codec.unpackb(data),
                 serialization.msgpack_restore(data))


def test_codec_refuses_what_flax_refuses():
    for bad in ({"t": (1, 2)}, {"o": object()}, {"a": np.array([None])}):
        with pytest.raises((TypeError, ValueError)):
            serialization.msgpack_serialize(bad)
        with pytest.raises((TypeError, ValueError)):
            msgpack_codec.packb(bad)
    with pytest.raises(ValueError, match="trailing"):
        msgpack_codec.unpackb(msgpack_codec.packb({"a": 1}) + b"\x00")


# ------------------------------------------------------- cross-package files
def _port_template(bundle):
    return {k: params_from_numpy(bundle[k], {}, "cpu")[0]
            for k in ("params", "state", "opt_state")}


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    bundle = _jax_bundle()
    meta = {"dev_map": 0.5, "history": {"steps": [0, 100]}}
    path = JC.save_checkpoint(str(tmp_path), 12, bundle, meta=meta)
    raw, got_meta = TC.load_checkpoint(path)
    assert _same(raw, serialization.msgpack_restore(
        open(os.path.join(path, "ckpt.msgpack"), "rb").read()))
    assert got_meta == {"step": 12, **meta}
    template = _port_template(bundle) | {"extra": bundle["extra"]}
    restored, _ = TC.load_checkpoint(path, template=template)
    assert _same(restored["extra"], raw["extra"])   # untemplated leaves
    for k in ("params", "state", "opt_state"):
        want = jax.tree.leaves(bundle[k])
        got = tree_leaves(restored[k])
        assert len(got) == len(want)
        for t, j in zip(got, want):
            assert torch.is_tensor(t) and np.array_equal(t.numpy(), j)


def test_port_checkpoint_loads_into_jax_with_flax_bytes(tmp_path):
    bundle = _jax_bundle()
    port = _port_template(bundle) | {"extra": bundle["extra"]}
    meta = {"dev_map": 0.25, "epoch": 3}
    t_path = TC.save_checkpoint(str(tmp_path / "t"), 7, port, meta=meta)
    j_path = JC.save_checkpoint(str(tmp_path / "j"), 7, bundle, meta=meta)
    for name in ("ckpt.msgpack", "meta.json"):
        assert open(os.path.join(t_path, name), "rb").read() == \
            open(os.path.join(j_path, name), "rb").read(), name
    assert not [f for f in os.listdir(t_path) if f.endswith(".tmp")]
    raw, got_meta = JC.load_checkpoint(t_path)
    assert _same(raw, JC.load_checkpoint(j_path)[0])
    assert _same(raw["params"], bundle["params"])
    assert got_meta == {"step": 7, **meta}
    # flax's template restore takes it too (without the lists, which
    # flax's restore wants as "0"-keyed maps)
    del port["extra"], bundle["extra"]
    t_path = TC.save_checkpoint(str(tmp_path / "t"), 8, port)
    restored, _ = JC.load_checkpoint(t_path, template=bundle)
    for a, b in zip(jax.tree.leaves(restored["params"]),
                    jax.tree.leaves(bundle["params"])):
        assert np.array_equal(np.asarray(a), b)


def test_template_restore_checks_shapes_and_keys(tmp_path):
    bundle = _jax_bundle()
    path = JC.save_checkpoint(str(tmp_path), 1, bundle)
    tpl = _port_template(bundle)
    tpl["extra"] = bundle["extra"]
    tpl["params"]["fc1"]["w"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="fc1/w"):
        TC.load_checkpoint(path, template=tpl)
    tpl = _port_template(bundle)          # no "extra": a key is missing
    with pytest.raises(ValueError, match="extra"):
        TC.load_checkpoint(path, template=tpl)


def test_copy_matching_and_weights_reports_equal_jax(tmp_path):
    """A checkpoint of one config into another: matching leaves load,
    others keep the template's values (shape mismatch, missing)."""
    src = _jax_bundle(dataclasses.replace(JQ.V4, vocab_size=120), seed=1)
    del src["params"]["fc2"]
    path = JC.save_checkpoint(str(tmp_path), 3, src)
    cfg = dataclasses.replace(JQ.V4, vocab_size=120, fc1_dim=16)
    j_params, j_state = jax.device_get(JQ.mms_qa_init(jax.random.PRNGKey(9),
                                                      cfg))
    j_params = jax.tree.map(np.asarray, j_params)
    j_state = jax.tree.map(np.asarray, j_state)
    t_params, t_state = params_from_numpy(j_params, j_state, "cpu")
    jp, js, j_report = JC.load_weights_into(j_params, j_state, path)
    tp, ts, t_report = TC.load_weights_into(t_params, t_state, path)
    assert t_report == j_report
    assert {"missing", "shape_mismatch", "loaded"} <= set(t_report.values())
    for t, j in zip(tree_leaves(tp) + tree_leaves(ts),
                    jax.tree.leaves(jp) + jax.tree.leaves(js)):
        assert np.array_equal(t.numpy(), np.asarray(j))
    # lists in a template, against lists and "0"-keyed maps in the source
    tpl = {"a": [np.zeros(2, np.float32), np.zeros(3, np.float32)]}
    for loaded in ({"a": [np.ones(2), np.ones(4)]},
                   {"a": {"0": np.ones(2), "1": np.ones(3)}}):
        (tm, t_rep), (jm, j_rep) = (TC.copy_matching(tpl, loaded),
                                    JC.copy_matching(tpl, loaded))
        assert t_rep == j_rep
        assert all(np.array_equal(a, b) for a, b in zip(tm["a"], jm["a"]))


def test_latest_checkpoint_equals_jax(tmp_path):
    for name in ("qa_iter_5", "qa_iter_12", "qa_iter_3", "qa_iter_x",
                 "best_iter_40", "qa_iter_7.tmp", "other_iter_99"):
        (tmp_path / name).mkdir()
    for prefix in ("qa", "best", "other", "none"):
        assert TC.latest_checkpoint(str(tmp_path), prefix=prefix) == \
            JC.latest_checkpoint(str(tmp_path), prefix=prefix)
    assert TC.latest_checkpoint(str(tmp_path / "absent")) is None


# ------------------------------------------------------------- fit resume
def _small_fit(snapshot_dir=None, **tkw):
    xml, w2v = synthetic_corpus(n_questions=10, answers_per_q=6, seed=1)
    splits, info = prepare_trec_qa(xml, xml, xml, w2v, q_len=12, a_len=10)
    cfg = dataclasses.replace(
        TQ.V4, vocab_size=info["vocab_size"], question_len=12,
        answer_len=10, blocks=(TQ.ConvBlock(3, 3, 6, "ave", 2, 2),
                               TQ.ConvBlock(2, 2, 8, "ave", 3, 1)),
        fc1_dim=8)   # the recipe's dropout stays on
    tcfg = TrainerConfig(**(dict(
        solver=SolverConfig(**RECIPE), max_iter=23, batch_size=10,
        test_interval=5, snapshot_interval=5, train_loss_record_interval=1,
        early_stop_patience=3, snapshot_dir=snapshot_dir) | tkw))
    return cfg, tcfg, splits, info


def _fit(cfg, tcfg, splits, info, **kw):
    return Trainer(cfg, tcfg, device="cpu").fit(
        splits["train"], splits["dev"], test_data=splits["test"],
        pretrained=info["pretrained"], **kw)


def _assert_same_run(got, want):
    for key in ("train_loss", "dev_map", "dev_mrr", "dev_auc", "test_map",
                "test_mrr", "test_auc", "steps", "best_step",
                "best_dev_map"):
        assert got[key] == want[key], key
    got, want = (_named({"p": h["params"], "s": h["state"]})
                 for h in (got, want))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


def _named(tree, prefix=""):
    """{path: leaf} of a tree of dicts, whatever its key order."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _named(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The uninterrupted run (patience 3 stops it early at step 18 on this
    corpus), and its last snapshot's bundle."""
    root = tmp_path_factory.mktemp("full")
    cfg, tcfg, splits, info = _small_fit(str(root))
    hist = _fit(cfg, tcfg, splits, info)
    return hist, root


@pytest.mark.parametrize("stop_at,chunk,from_root", [
    (10, 1, True), (5, 3, False), (15, 4, True)])
def test_fit_resumed_equals_the_uninterrupted_run(uninterrupted, tmp_path,
                                                   stop_at, chunk, from_root):
    full, full_root = uninterrupted
    cfg, tcfg, splits, info = _small_fit(str(tmp_path))
    first = dataclasses.replace(tcfg, max_iter=stop_at + 1)
    _fit(cfg, first, splits, info, steps_per_dispatch=chunk)
    resume = str(tmp_path) if from_root else str(tmp_path
                                                 / f"qa_iter_{stop_at}")
    resumed = _fit(cfg, tcfg, splits, info, resume_from=resume,
                   steps_per_dispatch=chunk)
    _assert_same_run(resumed, full)
    # the snapshots of the two runs are the same files
    for name in sorted(os.listdir(full_root)):
        for f in ("ckpt.msgpack", "meta.json"):
            assert (full_root / name / f).read_bytes() == \
                (tmp_path / name / f).read_bytes(), (name, f)


def test_sighup_snapshots_and_carries_on(tmp_path):
    import signal

    cfg, tcfg, splits, info = _small_fit(str(tmp_path), snapshot_interval=0,
                                         early_stop_patience=50)

    def hup(event):
        if event["step"] == 10:
            os.kill(os.getpid(), signal.SIGHUP)

    hist = _fit(cfg, tcfg, splits, info, callback=hup, handle_signals=True)
    assert hist["steps"] == [0, 5, 10, 15, 20]      # it carried on
    assert sorted(os.listdir(tmp_path)) == ["qa_iter_10"]
    meta = json.loads((tmp_path / "qa_iter_10" / "meta.json").read_text())
    assert meta["signal"] == "SNAPSHOT" and meta["step"] == 10
    assert meta["history"]["steps"] == [0, 5, 10]


def test_weights_finetune_from_a_jax_checkpoint(tmp_path):
    """``weights=`` loads a JAX-written checkpoint's params and BN state by
    name and shape, then trains from them: the run equals one whose init
    is those params."""
    cfg, tcfg, splits, info = _small_fit(early_stop_patience=50,
                                         max_iter=12)
    jcfg = JQ.MMSQAConfig(**{**dataclasses.asdict(cfg), "blocks": tuple(
        JQ.ConvBlock(**dataclasses.asdict(b)) for b in cfg.blocks)})
    rng = np.random.default_rng(4)
    params, state = jax.device_get(JQ.mms_qa_init(jax.random.PRNGKey(3),
                                                  jcfg))
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.normal(
        size=x.shape).astype(np.float32), params)
    state = jax.tree.map(np.asarray, state)
    path = JC.save_checkpoint(str(tmp_path), 0, {"params": params,
                                                 "state": state})
    tuned = _fit(cfg, tcfg, splits, info, weights=path)

    class FromParams(Trainer):
        def init(self, *, pretrained=None):
            super().init(pretrained=pretrained)
            p, s = params_from_numpy(params, state, self.device)
            return p, s, self.solver.init(p)

    want = FromParams(cfg, tcfg, device="cpu").fit(
        splits["train"], splits["dev"], test_data=splits["test"],
        pretrained=info["pretrained"])
    _assert_same_run(tuned, want)


def test_reference_files_name_the_roadmap_item():
    """The reference's .caffemodel / .solverstate paths are read now (the
    roadmap item is done): a missing one raises FileNotFoundError naming
    it, never a silent fallback."""
    cfg, tcfg, splits, info = _small_fit(max_iter=2)
    for path in ("run.caffemodel", "run_iter_5.solverstate"):
        for kw in ("resume_from", "weights"):
            with pytest.raises(FileNotFoundError, match="run"):
                _fit(cfg, tcfg, splits, info, **{kw: path})


def _jax_trainer_trees(cfg, seed):
    """A JAX Trainer's initial params and state (its own init), made
    distinctive, as numpy."""
    from mms_answer_selection_tpu.training import Trainer as JTrainer

    jcfg = JQ.MMSQAConfig(**{**dataclasses.asdict(cfg), "blocks": tuple(
        JQ.ConvBlock(**dataclasses.asdict(b)) for b in cfg.blocks)})
    params, state, _ = JTrainer(jcfg, JTrainerConfig()).init()
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.normal(
        size=x.shape).astype(np.float32), jax.device_get(params))
    state = jax.tree.map(lambda x: np.asarray(x) + rng.uniform(
        0.1, 0.2, x.shape).astype(np.float32), jax.device_get(state))
    return params, state


@pytest.mark.parametrize("fmt", ["binaryproto", "h5"])
def test_weights_finetune_from_a_jax_caffemodel(tmp_path, fmt):
    """``weights=`` a .caffemodel the JAX package wrote from its Trainer's
    model (binaryproto or HDF5): the run equals one whose init is those
    params and BN state."""
    from mms_answer_selection_tpu.utils import caffemodel as JCM

    cfg, tcfg, splits, info = _small_fit(early_stop_patience=50,
                                         max_iter=12)
    params, state = _jax_trainer_trees(cfg, 5)
    path = str(tmp_path / f"w.caffemodel{'.h5' if fmt == 'h5' else ''}")
    getattr(JCM, f"save_caffemodel_{fmt}")(path, params, state)
    tuned = _fit(cfg, tcfg, splits, info, weights=path)

    class FromParams(Trainer):
        def init(self, *, pretrained=None):
            super().init(pretrained=pretrained)
            p, s = params_from_numpy(params, state, self.device)
            return p, s, self.solver.init(p)

    want = FromParams(cfg, tcfg, device="cpu").fit(
        splits["train"], splits["dev"], test_data=splits["test"],
        pretrained=info["pretrained"])
    _assert_same_run(tuned, want)


def test_resume_from_a_jax_solverstate(tmp_path):
    """``resume_from=`` a .solverstate the JAX package wrote: the solver
    history and the iteration from it, the weights from its learned_net;
    the run carries on from that iteration."""
    from mms_answer_selection_tpu.utils import caffemodel as JCM

    cfg, tcfg, splits, info = _small_fit(early_stop_patience=50,
                                         max_iter=12, snapshot_interval=0)
    params, state = _jax_trainer_trees(cfg, 6)
    rng = np.random.default_rng(7)
    opt = {a: jax.tree.map(lambda x: rng.uniform(
        0.0, 1e-3, x.shape).astype(np.float32), params) for a in ("h", "h2")}
    JCM.save_caffemodel_binaryproto(str(tmp_path / "r_iter_7.caffemodel"),
                                    params, state)
    path = str(tmp_path / "r_iter_7.solverstate")
    JCM.save_solverstate_binaryproto(path, params, state, opt, 7,
                                     learned_net="r_iter_7.caffemodel")
    tr = Trainer(cfg, tcfg, device="cpu")
    p0, s0, o0 = tr.init(pretrained=info["pretrained"])
    p, s, o, meta = tr._resume(path, p0, s0, o0, {}, {})
    assert meta["step"] == 6
    for got, want in ((p, params), (s, state), (o, opt)):
        got, want = _named(got), _named(want)
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert np.array_equal(t.numpy(), want[name]), name
    hist = _fit(cfg, tcfg, splits, info, resume_from=path)
    assert hist["steps"] == [10]      # evals at 10 only: it ran 7..11
