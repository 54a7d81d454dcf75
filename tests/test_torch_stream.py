"""The port's input pipeline against the JAX package's, on CPU: the packed
store (``write_mmsp``'s bytes, ``native_shuffle``, gathers and the
prefetch ring's batches on one file), ``BatchIterator``, ``next_device``,
and ``fit_stream`` (its history against JAX's on the same native stream,
and snapshot/resume against the uninterrupted run).

Tolerances: none for the data (the same C++ source, the same bytes and
rows); ``fit_stream`` against JAX at rtol 1e-4, atol 1e-4 on losses and
metrics, as ``test_torch_training.py``'s ``fit`` (float32 sums in another
order; dropout off, a xavier W, the same initial weights); a resumed
``fit_stream`` equals the uninterrupted one bit for bit.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.data import loader as JL
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.native import packed_format as JP
from mms_answer_selection_tpu.training import (
    SolverConfig as JSolverConfig,
    Trainer as JTrainer,
    TrainerConfig as JTrainerConfig,
)
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.data import (
    prepare_trec_qa,
    synthetic_corpus,
)
from mms_answer_selection_tpu_torch.data import loader as TL
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.native import packed_format as TP
from mms_answer_selection_tpu_torch.training import (
    SolverConfig,
    Trainer,
    TrainerConfig,
)
from mms_answer_selection_tpu_torch.training.checkpoint import load_checkpoint

STEP_TOL = dict(rtol=1e-4, atol=1e-4)
RECIPE = dict(solver_type="adadelta", base_lr=1.0, momentum=0.95,
              delta=5e-7, weight_decay=5e-4)
FIELDS = ["question", "answer", "label", "overlap_feat"]


def _arrays(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return {"question": rng.integers(0, 90, (n, 7)).astype(np.int32),
            "answer": rng.integers(0, 90, (n, 5)),              # int64
            "label": (rng.random(n) < 0.3).astype(np.int8),     # 1-D
            "overlap_feat": rng.random((n, 2)),                 # float64
            "cube": rng.random((n, 2, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmsp")
    arrays = _arrays()
    TP.write_mmsp(str(root / "t.mmsp"), arrays)
    JP.write_mmsp(str(root / "j.mmsp"), arrays)
    return root, arrays


# --------------------------------------------------------------- the store
def test_write_mmsp_bytes_equal_jax(files):
    root, _ = files
    assert (root / "t.mmsp").read_bytes() == (root / "j.mmsp").read_bytes()
    with pytest.raises(ValueError, match="31-byte"):
        TP.write_mmsp(str(root / "bad.mmsp"), {"x" * 32: np.zeros(3)})
    with pytest.raises(ValueError, match="ragged"):
        TP.write_mmsp(str(root / "bad.mmsp"), {"a": np.zeros(3),
                                               "b": np.zeros(4)})


def test_store_fields_and_gather_equal_jax(files):
    root, arrays = files
    t, j = TP.PackedStore(str(root / "t.mmsp")), JP.PackedStore(
        str(root / "j.mmsp"))
    assert t.n_rows == j.n_rows == 37 and t.fields == j.fields
    idx = np.array([36, 0, 5, 5, 17])
    for name in arrays:
        np.testing.assert_array_equal(t.gather(name, idx),
                                      j.gather(name, idx))
    np.testing.assert_array_equal(t.gather("cube", idx),
                                  arrays["cube"][idx].reshape(5, 6))
    with pytest.raises(IndexError):
        t.gather("label", [37])
    with pytest.raises(IOError):
        TP.PackedStore(str(root / "absent.mmsp"))


@pytest.mark.parametrize("n,seed", [(1, 0), (10, 3), (1000, 22)])
def test_native_shuffle_equals_jax(n, seed):
    np.testing.assert_array_equal(TP.native_shuffle(n, seed),
                                  JP.native_shuffle(n, seed))
    with pytest.raises(ValueError):
        TP.native_shuffle(0, seed)


@pytest.mark.parametrize("kw", [dict(seed=5), dict(shuffle=False),
                                dict(seed=9, shard=(1, 3), depth=2)],
                         ids=["shuffle", "ordered", "shard"])
def test_prefetcher_batches_equal_jax(files, kw):
    root, _ = files
    t = TP.NativePrefetcher(TP.PackedStore(str(root / "t.mmsp")), FIELDS,
                            8, **kw)
    j = JP.NativePrefetcher(JP.PackedStore(str(root / "j.mmsp")), FIELDS,
                            8, **kw)
    for _ in range(12):                      # several passes over 37 rows
        tb, jb = t.next(), j.next()
        assert list(tb) == FIELDS
        for name in FIELDS:
            np.testing.assert_array_equal(tb[name], jb[name])
    with pytest.raises(ValueError, match="empty"):
        TP.NativePrefetcher(t.store, FIELDS, 8, shard=(40, 41))


def test_next_device_cpu_copies_out_of_the_slot(files):
    """next_device("cpu") gives next()'s batches as tensors that own their
    memory: batches kept while the ring refills its slots stay intact."""
    root, _ = files
    store = TP.PackedStore(str(root / "t.mmsp"))
    a = TP.NativePrefetcher(store, FIELDS, 8, seed=2, depth=2)
    b = TP.NativePrefetcher(store, FIELDS, 8, seed=2, depth=2)
    kept = [a.next_device("cpu") for _ in range(10)]
    for got in kept:
        want = b.next()
        for name in FIELDS:
            assert torch.is_tensor(got[name])
            np.testing.assert_array_equal(got[name].numpy(), want[name])
    with pytest.raises(RuntimeError, match="acquire called twice"):
        a.acquire_view()
        a.acquire_view()
    a.release()
    if not torch.cuda.is_available():      # None means CUDA: no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            a.next_device()


def test_library_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "packed_store.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TP, "SOURCE", bad)
    monkeypatch.setattr(TP, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TP.build_library()
    monkeypatch.setenv("PATH", str(tmp_path))     # no g++ on the PATH
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        TP.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_keyed_on_the_source():
    assert TP.library_path().parent == TP.BUILD_DIR
    assert TP.SOURCE.read_bytes() == open(
        os.path.join(os.path.dirname(JP.__file__), "packed_store.cc"),
        "rb").read()


# ------------------------------------------------------------- BatchIterator
@pytest.mark.parametrize("kw", [dict(), dict(shard=(1, 3)),
                                dict(drop_keys=("cube",))],
                         ids=["all", "shard", "drop"])
def test_batch_iterator_unshuffled_equals_jax(kw):
    arrays = _arrays(23)
    t = TL.BatchIterator(TL.ArrayDataset(arrays), 5, shuffle=False, **kw)
    j = JL.BatchIterator(JL.ArrayDataset(arrays), 5, shuffle=False, **kw)
    for _ in range(9):                       # wraps around several epochs
        tb, jb = next(t), next(j)
        assert list(tb) == list(jb)
        for name in tb:
            np.testing.assert_array_equal(tb[name], jb[name])
    assert t.epoch == j.epoch


def test_batch_iterator_shuffles_each_epoch_deterministically():
    arrays = {"i": np.arange(10)}
    runs = [TL.BatchIterator(TL.ArrayDataset(arrays), 5, seed=3)
            for _ in range(2)]
    epochs = [[np.concatenate([next(r)["i"] for _ in range(2)])
               for _ in range(3)] for r in runs]
    for e in epochs[0]:
        assert sorted(e) == list(range(10))
    assert all(np.array_equal(a, b) for a, b in zip(*epochs))
    assert not np.array_equal(epochs[0][0], epochs[0][1])
    on = next(TL.BatchIterator(TL.ArrayDataset(arrays), 4, shuffle=False,
                               device="cpu"))
    assert torch.equal(on["i"], torch.arange(4))
    with pytest.raises(ValueError, match="empty"):
        TL.BatchIterator(TL.ArrayDataset(arrays), 2, shard=(12, 13))
    with pytest.raises(ValueError, match="ragged"):
        TL.ArrayDataset({"a": np.zeros(2), "b": np.zeros(3)})


# ---------------------------------------------------------------- fit_stream
def _corpus():
    xml, w2v = synthetic_corpus(n_questions=10, answers_per_q=6, seed=1)
    return prepare_trec_qa(xml, xml, xml, w2v, q_len=12, a_len=10)


def _jcfg(vocab_size):
    return dataclasses.replace(
        JQ.V4, vocab_size=vocab_size, question_len=12, answer_len=10,
        blocks=(JQ.ConvBlock(3, 3, 6, "ave", 2, 2),
                JQ.ConvBlock(2, 2, 8, "ave", 3, 1)),
        fc1_dim=8, sim_dropout=0.0, fc1_dropout=0.0,
        sim_weight_init="xavier")


def _tcfg(jcfg):
    return TQ.MMSQAConfig(**{**dataclasses.asdict(jcfg), "blocks": tuple(
        TQ.ConvBlock(**dataclasses.asdict(b)) for b in jcfg.blocks)})


TRAIN = dict(max_iter=40, batch_size=10, test_interval=5,
             train_loss_record_interval=1, seed=22)


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Both packages' fit_stream over one packed file (the same prefetch
    ring), from the same initial weights, dropout off."""
    root = tmp_path_factory.mktemp("stream")
    splits, info = _corpus()
    path = str(root / "train.mmsp")
    TP.write_mmsp(path, splits["train"])
    jcfg = _jcfg(info["vocab_size"])
    jt = JTrainer(jcfg, JTrainerConfig(solver=JSolverConfig(**RECIPE),
                                       **TRAIN), donate=False)
    p, s, o = jt.init(pretrained=info["pretrained"])
    p_np, s_np = jax.tree.map(np.asarray, jax.device_get((p, s)))
    stops = {"jax": [], "torch": []}
    jh = jt.fit_stream(
        JP.NativePrefetcher(JP.PackedStore(path), FIELDS, 10, seed=22),
        splits["dev"], steps=40, test_data=splits["test"], params=p,
        state=s, opt_state=o, patience_evals=3,
        callback=stops["jax"].append)
    tt = Trainer(_tcfg(jcfg), TrainerConfig(solver=SolverConfig(**RECIPE),
                                            **TRAIN), device="cpu")
    tt.init()
    tp, ts = params_from_numpy(p_np, s_np, "cpu")
    th = tt.fit_stream(
        TP.NativePrefetcher(TP.PackedStore(path), FIELDS, 10, seed=22),
        splits["dev"], steps=40, test_data=splits["test"], params=tp,
        state=ts, opt_state=tt.solver.init(tp), patience_evals=3,
        callback=stops["torch"].append)
    return jh, th, stops, path, splits, info, tt


def test_fit_stream_history_matches_jax(streamed):
    jh, th, stops, *_ = streamed
    assert th["steps"] == jh["steps"] and th["best_step"] == jh["best_step"]
    assert len(th["train_loss"]) == len(jh["train_loss"])
    assert [c["step"] for c in stops["torch"]] == \
        [c["step"] for c in stops["jax"]]
    for key in ("train_loss", "dev_map", "dev_mrr", "dev_auc", "test_map",
                "test_mrr", "test_auc"):
        np.testing.assert_allclose(th[key], jh[key], **STEP_TOL, err_msg=key)
    for name, sub in th["params"].items():
        for k, t in sub.items():
            if name.startswith("conv") and k == "b":
                continue      # rounding noise under train-mode BN
            np.testing.assert_allclose(t.numpy(), np.asarray(
                jh["params"][name][k]), **STEP_TOL, err_msg=f"{name}.{k}")


def _stream_run(path, splits, info, snapshot_dir, steps, skip=0, chunk=1,
                **kw):
    cfg = dataclasses.replace(_tcfg(_jcfg(info["vocab_size"])),
                              sim_dropout=0.1, fc1_dropout=0.5)
    tcfg = TrainerConfig(solver=SolverConfig(**RECIPE), snapshot_interval=4,
                         snapshot_dir=snapshot_dir,
                         **(TRAIN | dict(test_interval=4)))
    batches = TP.NativePrefetcher(TP.PackedStore(path), FIELDS, 10, seed=7)
    for _ in range(skip):       # the caller repositions the stream
        next(batches)
    return Trainer(cfg, tcfg, device="cpu").fit_stream(
        batches, splits["dev"], steps=steps, test_data=splits["test"],
        pretrained=info["pretrained"], steps_per_dispatch=chunk, **kw)


@pytest.mark.parametrize("chunk", [1, 3])
def test_fit_stream_resumed_equals_the_uninterrupted_run(streamed, tmp_path,
                                                         chunk):
    *_, path, splits, info, _ = streamed
    full = _stream_run(path, splits, info, str(tmp_path / "a"), 17)
    _stream_run(path, splits, info, str(tmp_path / "b"), 11)  # 0, 4, 8
    resumed = _stream_run(path, splits, info, str(tmp_path / "b"), 17,
                          skip=9, chunk=chunk,
                          resume_from=str(tmp_path / "b"))
    for key in ("train_loss", "dev_map", "test_map", "steps", "best_step",
                "best_dev_map"):
        assert resumed[key] == full[key], key
    for name in ("qa_iter_16", f"qa_iter_{full['best_step']}"):
        a, ma = load_checkpoint(str(tmp_path / "a" / name))
        b, mb = load_checkpoint(str(tmp_path / "b" / name))
        assert ma == mb and ma["stream"] is True
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    assert all(torch.equal(resumed["params"][n][k], full["params"][n][k])
               for n in full["params"] for k in full["params"][n])


def test_fit_stream_iter_size_and_plain_iterators(streamed):
    """iter_size 2 stacks two stream batches a step; a plain iterator of
    numpy batches trains like the prefetcher it was copied from."""
    *_, path, splits, info, tt = streamed
    cfg = tt.model_cfg
    tcfg = TrainerConfig(solver=SolverConfig(iter_size=2, **RECIPE),
                         **(TRAIN | dict(max_iter=6, test_interval=3)))
    ring = TP.NativePrefetcher(TP.PackedStore(path), FIELDS, 10, seed=1)
    copies = TP.NativePrefetcher(TP.PackedStore(path), FIELDS, 10, seed=1)
    runs = [Trainer(cfg, tcfg, device="cpu").fit_stream(
        batches, splits["dev"], steps=6, pretrained=info["pretrained"])
        for batches in (ring, iter([copies.next() for _ in range(12)]))]
    assert runs[0]["steps"] == [0, 3] and len(runs[0]["train_loss"]) == 6
    assert runs[0]["train_loss"] == runs[1]["train_loss"]
    short = Trainer(cfg, tcfg, device="cpu").fit_stream(
        iter([copies.next() for _ in range(7)]), splits["dev"], steps=6,
        pretrained=info["pretrained"])           # exhausted after 3 steps
    assert len(short["train_loss"]) == 3
