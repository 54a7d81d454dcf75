"""``deploy.py``: the eval forward and the weights in one ``torch.export``
artifact, mirroring ``tests/test_deploy.py``: parity with the live model
(within 1e-5: the same operators; a program replays them), one artifact at
batch 1 and 7, a pinned batch, the file's refusals, and the header read
without the program.  The live model is the JAX package's weights carried
over, and the JAX package's own ``mms_qa_apply`` is the reference."""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu_torch import deploy
from mms_answer_selection_tpu_torch.convert import params_from_numpy
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk

JCFG = JQ.MMSQAConfig(
    vocab_size=40, embed_dim=16, question_len=8, answer_len=8,
    sim_measures=2,
    blocks=(JQ.ConvBlock(3, 3, 4, "ave", 2, 2),
            JQ.ConvBlock(2, 2, 4, "ave", 1, 1)),
    fc1_dim=4)
TCFG = TQ.MMSQAConfig(**{**dataclasses.asdict(JCFG), "blocks": tuple(
    TQ.ConvBlock(**dataclasses.asdict(b)) for b in JCFG.blocks)})
TOL = 1e-5

rng = np.random.default_rng(3)


@pytest.fixture(scope="module")
def model():
    params, state = JQ.mms_qa_init(jax.random.PRNGKey(0), JCFG)
    params = jax.tree.map(np.asarray, params)
    params["sim"]["w"] = rng.normal(
        size=params["sim"]["w"].shape).astype(np.float32) * 0.2
    state = {k: {"mean": rng.normal(size=v["mean"].shape).astype(
        np.float32) * 0.1, "var": rng.random(v["var"].shape).astype(
        np.float32) + 0.5} for k, v in state.items()}
    return params, state


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("deploy") / "m.mmst")
    tp, ts = params_from_numpy(*model, "cpu")
    header = deploy.save_scorer(path, tp, ts, TCFG)
    return path, header


def _batch(n):
    return (rng.integers(0, JCFG.vocab_size, (n, JCFG.question_len)),
            rng.integers(0, JCFG.vocab_size, (n, JCFG.answer_len)),
            rng.random((n, JCFG.overlap_features)).astype(np.float32))


def _close(got, want):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * max(scale, 1.0)


def test_matches_live_model(model, artifact):
    params, state = model
    path, header = artifact
    assert header["question_len"] == JCFG.question_len
    assert header["pair_maps"] == "custom_op"
    assert header["torch"] == torch.__version__
    scorer = deploy.load_scorer(path, device="cpu")
    q, a, o = _batch(5)
    logits, prob = scorer(q, a, o)
    want, _ = JQ.mms_qa_apply(
        params, state, {"question": jnp.asarray(q, jnp.int32),
                        "answer": jnp.asarray(a, jnp.int32),
                        "overlap_feat": jnp.asarray(o)}, JCFG, train=False)
    _close(logits, np.asarray(want["logits"]))
    _close(prob, np.asarray(want["prob"]))
    live, _ = TQ.mms_qa_apply(
        *params_from_numpy(params, state, "cpu"),
        {"question": torch.as_tensor(q), "answer": torch.as_tensor(a),
         "overlap_feat": torch.as_tensor(o)}, TCFG, train=False)
    _close(logits, live["logits"].numpy())
    np.testing.assert_array_equal(scorer.score(q, a, o), prob[:, 1])


@pytest.mark.parametrize("n", [1, 7])
def test_symbolic_batch_serves_any_size(artifact, n):
    scorer = deploy.load_scorer(artifact[0], device="cpu")
    logits, prob = scorer(*_batch(n))
    assert logits.shape == (n, 2) and prob.shape == (n, 2)
    np.testing.assert_allclose(prob.sum(-1), 1.0, rtol=1e-5)


def test_program_carries_the_pair_map_operator(artifact):
    scorer = deploy.load_scorer(artifact[0], device="cpu")
    targets = [str(n.target) for n in scorer.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mms_torch.pair_maps_fwd.default") == 1
    # on CPU tensors the operator runs the plain version: no launch
    before = dict(sk.LAUNCH_COUNTS)
    scorer(*_batch(3))
    assert sk.LAUNCH_COUNTS == before


def test_pinned_batch(model, tmp_path):
    tp, ts = params_from_numpy(*model, "cpu")
    path = str(tmp_path / "b4.mmst")
    header = deploy.save_scorer(path, tp, ts, TCFG, batch=4)
    assert header["batch"] == 4
    scorer = deploy.load_scorer(path, device="cpu")
    logits, _ = scorer(*_batch(4))
    assert logits.shape == (4, 2)
    with pytest.raises(Exception):  # noqa: B017 — shape mismatch
        scorer(*_batch(3))


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "x.mmst"
    p.write_bytes(b"NOTMAGIC" + b"\0" * 32)
    with pytest.raises(ValueError, match="magic"):
        deploy.load_scorer(str(p), device="cpu")
    # the JAX package's artifact is not this package's either
    p.write_bytes(b"MMSXPRT1" + b"\0" * 32)
    with pytest.raises(ValueError, match="magic"):
        deploy.load_scorer(str(p), device="cpu")


def _rewrite_header(src, dst, **changes):
    with open(src, "rb") as f:
        magic = f.read(8)
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        blob = f.read()
    hb = json.dumps({**header, **changes}).encode()
    with open(dst, "wb") as f:
        f.write(magic + struct.pack("<Q", len(hb)) + hb + blob)


def test_bad_format_rejected(artifact, tmp_path):
    path = str(tmp_path / "f.mmst")
    _rewrite_header(artifact[0], path, format=2)
    with pytest.raises(ValueError, match="format"):
        deploy.load_scorer(path, device="cpu")


def test_other_torch_version_rejected(artifact, tmp_path):
    path = str(tmp_path / "v.mmst")
    _rewrite_header(artifact[0], path, torch="1.0.0")
    with pytest.raises(ValueError, match="torch"):
        deploy.load_scorer(path, device="cpu")


def test_truncated_rejected(artifact, tmp_path):
    path = str(tmp_path / "t.mmst")
    blob = open(artifact[0], "rb").read()
    open(path, "wb").write(blob[:-20])
    with pytest.raises(ValueError, match="truncated"):
        deploy.load_scorer(path, device="cpu")


def test_header_readable_without_program(artifact):
    with open(artifact[0], "rb") as f:
        assert f.read(8) == deploy.MAGIC
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    assert header["vocab_size"] == JCFG.vocab_size
    assert header == artifact[1]


def test_platforms_default_and_header(artifact):
    """``platforms`` as the JAX package's keyword: the port's default is
    ("cpu", "cuda"), written into the header as the JAX header lists its
    lowering targets."""
    import inspect

    from mms_answer_selection_tpu import deploy as jdeploy

    assert artifact[1]["platforms"] == ["cpu", "cuda"]
    for fn in ("export_scorer", "save_scorer"):
        tp = inspect.signature(getattr(deploy, fn)).parameters["platforms"]
        jp = inspect.signature(getattr(jdeploy, fn)).parameters["platforms"]
        assert tp.kind == jp.kind == inspect.Parameter.KEYWORD_ONLY
        assert tp.default == ("cpu", "cuda") and jp.default == ("cpu", "tpu")


def test_load_refuses_a_device_the_header_does_not_name(model, tmp_path):
    tp, ts = params_from_numpy(*model, "cpu")
    path = str(tmp_path / "cuda_only.mmst")
    header = deploy.save_scorer(path, tp, ts, TCFG, platforms=("cuda",))
    assert header["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="exported for \\[.cuda.\\]"):
        deploy.load_scorer(path, device="cpu")
    path = str(tmp_path / "cpu_only.mmst")
    deploy.save_scorer(path, tp, ts, TCFG, platforms=["cpu"])
    logits, _ = deploy.load_scorer(path, device="cpu")(*_batch(2))
    assert logits.shape == (2, 2)


@pytest.mark.parametrize("platforms", [("cpu", "tpu"), ("rocm",), ()])
def test_a_platform_the_port_cannot_run_is_refused(model, tmp_path,
                                                   platforms):
    tp, ts = params_from_numpy(*model, "cpu")
    path = tmp_path / "x.mmst"
    name = platforms[-1] if platforms else "\\[\\]"
    for fn, args in ((deploy.save_scorer, (str(path), tp, ts, TCFG)),
                     (deploy.export_scorer, (tp, ts, TCFG))):
        with pytest.raises(ValueError, match=name):
            fn(*args, platforms=platforms)
    assert not path.exists()


def test_cuda_load_without_a_card_raises(artifact):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        deploy.load_scorer(artifact[0])
