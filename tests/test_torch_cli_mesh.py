"""The CLI's multi-rank ``--mesh-dp`` as users start it, under a launcher,
on the CPU against the JAX CLI.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
mms_answer_selection_tpu_torch.cli train --mesh-dp 2 ...`` (and ``solve``,
the generic ``caffe train``) over two gloo ranks, each a process that
joins through ``multihost.initialize``; the JAX CLI's ``--mesh-dp 2``
runs in this process over two of the CPU devices ``tests/conftest.py``
provides.  Both start from one set of weights (JAX's init, written as a
checkpoint or a ``.caffemodel``), with dropout off (the packages draw
masks from different generators) and the batches in one order (``train
--stream`` reads the packed store, whose ring gives both packages the
same batches; the solver's HDF5 source is not shuffled).

What is held: the snapshots within STEP_TOL (rtol 1e-4, atol 1e-4), the
conv biases ahead of a train-mode BN, whose gradient is rounding noise,
within the solver's band (``test_torch_parallel_2d._noise_band``); the
history and the printed losses within STEP_TOL; the trec_eval table that
rank 0 alone prints equal to the JAX CLI's ``eval`` of the snapshot it
wrote.  A batch the dp size does not divide is refused as JAX's
``jit(in_shardings=P("dp"))`` refuses it, naming both sizes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mms_answer_selection_tpu import cli as JCLI
from mms_answer_selection_tpu.models import mms_qa as JQ
from mms_answer_selection_tpu.training import Trainer as JTrainer, \
    TrainerConfig as JTrainerConfig
from mms_answer_selection_tpu.training.checkpoint import \
    save_checkpoint as j_save_checkpoint
from mms_answer_selection_tpu.training.graph_solver import \
    GraphSolver as JGraphSolver
from mms_answer_selection_tpu.utils.caffemodel import \
    save_caffemodel_binaryproto as j_save_caffemodel
from mms_answer_selection_tpu_torch import cli
from mms_answer_selection_tpu_torch.data import synthetic_corpus
from mms_answer_selection_tpu_torch.models import mms_qa as TQ
from mms_answer_selection_tpu_torch.training import SolverConfig, \
    TrainerConfig
from mms_answer_selection_tpu_torch.training.checkpoint import load_checkpoint
from mms_answer_selection_tpu_torch.utils import config as TConfig
from mms_answer_selection_tpu_torch.utils.caffemodel import _parse_layers
from mms_answer_selection_tpu_torch.utils.prototxt import (
    net_prototxt_from_config, solver_prototxt_from_config)
from test_torch_parallel import NOISE, STEP_TOL, _named
from test_torch_parallel_2d import SOLVERS, _noise_band

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEPS, EVERY, BATCH = 10, 5, 10


def _torchrun(argv, nproc=2):
    """``argv`` of the port's CLI under torchrun: ``nproc`` CPU ranks."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m",
         "mms_answer_selection_tpu_torch.cli", *argv, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One corpus prepped by the port's CLI (its artifacts equal the JAX
    CLI's, ``test_torch_cli.py``), with the packed store and the HDF5
    chunks; a small V4 with a xavier metric and no dropout."""
    root = tmp_path_factory.mktemp("cli_mesh")
    xml, w2v = synthetic_corpus(n_questions=8, answers_per_q=5, seed=4)
    (root / "d.xml").write_text(xml)
    with open(root / "glove.txt", "w") as f:
        for w, v in w2v.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
    cli.main(["prep", "--train-xml", str(root / "d.xml"), "--dev-xml",
              str(root / "d.xml"), "--test-xml", str(root / "d.xml"),
              "--glove", str(root / "glove.txt"), "--out",
              str(root / "prep"), "--q-len", "12", "--a-len", "12",
              "--mmsp", "--hdf5"])
    meta = json.loads((root / "prep" / "meta.json").read_text())
    model = TQ.MMSQAConfig(
        vocab_size=meta["vocab_size"], embed_dim=50, question_len=12,
        answer_len=12, sim_measures=2, sim_weight_init="xavier",
        sim_dropout=0.0, fc1_dropout=0.0,
        blocks=(TQ.ConvBlock(3, 3, 4, "ave", 2, 2),
                TQ.ConvBlock(3, 3, 4, "ave", 3, 1)), fc1_dim=4)
    return root, model


def _jmodel(model):
    return JQ.MMSQAConfig(**{**model.__dict__, "blocks": tuple(
        JQ.ConvBlock(**b.__dict__) for b in model.blocks)})


def _table(lines):
    """{measure: value} of a trec_eval table among printed lines."""
    rows = [ln.split("\t") for ln in lines]
    return {r[0].strip(): float(r[2]) for r in rows
            if len(r) == 3 and r[1] == "all"}


# -------------------------------------------------------------------- train
@pytest.mark.parametrize("solver", ["adadelta", "sgd"])
def test_cli_train_mesh_dp2_under_torchrun_equals_jax(corpus, tmp_path,
                                                      capsys, solver):
    """``train --stream --mesh-dp 2`` over two launched ranks, snapshots
    every 5 steps: each snapshot and the best one equal the JAX CLI's over
    two devices, the history too; rank 0 alone prints the best dev MAP
    and the test split's trec_eval table, which the JAX CLI's ``eval``
    of the port's best snapshot prints; the other rank writes nothing."""
    root, model = corpus
    exps = {}
    for name in ("jax", "port"):
        exps[name] = tmp_path / name
        exps[name].mkdir()
        trainer = TrainerConfig(
            solver=SolverConfig(**SOLVERS[solver]), max_iter=STEPS,
            batch_size=BATCH, test_interval=EVERY, snapshot_interval=EVERY,
            early_stop_patience=99, train_loss_record_interval=1,
            snapshot_dir=str(exps[name] / "models"))
        (exps[name] / "cfg.json").write_text(
            TConfig.experiment_to_json(model, trainer))
    # one set of initial weights: JAX's init as a checkpoint, which both
    # CLIs load through --weights
    p0, s0, _ = JTrainer(_jmodel(model), JTrainerConfig()).init()
    init = j_save_checkpoint(str(tmp_path / "init"), 0,
                             {"params": p0, "state": s0})
    argv = ["train", "--data", str(root / "prep"), "--stream", "--weights",
            init, "--mesh-dp", "2"]
    JCLI.main([*argv, "--exp", str(exps["jax"]), "--config",
               str(exps["jax"] / "cfg.json")])
    j_lines = capsys.readouterr().out.splitlines()
    proc = _torchrun([*argv, "--exp", str(exps["port"]), "--config",
                      str(exps["port"] / "cfg.json")])
    assert proc.returncode == 0, proc.stderr[-4000:]
    t_lines = proc.stdout.splitlines()

    # rank 0 alone printed: one best line and one table
    best = [ln for ln in t_lines if ln.startswith("best dev MAP")]
    assert len(best) == 1
    assert sum(ln.startswith("map") for ln in t_lines) == 1
    j_best = [ln for ln in j_lines if ln.startswith("best dev MAP")][0]
    assert best[0].split("@")[1] == j_best.split("@")[1]     # the step
    assert abs(float(best[0].split()[3]) - float(j_best.split()[3])) <= 1e-4

    band = _noise_band(solver, STEPS)
    bands = {"params": band, "state": band,
             "opt_state": band if solver == "sgd" else max(1e-6, band ** 2)}
    snaps = sorted(p.name for p in (exps["jax"] / "models").iterdir())
    assert snaps == sorted(p.name for p in (exps["port"] / "models")
                           .iterdir()) and len(snaps) == STEPS // EVERY
    bests = [p.name for p in exps["jax"].glob("best_iter_*")]
    assert bests == [p.name for p in exps["port"].glob("best_iter_*")]
    for path in [f"models/{s}" for s in snaps] + bests:
        got, _ = load_checkpoint(str(exps["port"] / path))
        want, _ = load_checkpoint(str(exps["jax"] / path))
        assert got.keys() == want.keys()
        for (name, g), (_, w) in zip(_named(got), _named(want)):
            if ".".join(name.split(".")[-2:]) in NOISE + ("bn0.mean",
                                                         "bn1.mean"):
                assert np.abs(g - w).max() <= bands[name.split(".")[0]], \
                    (path, name)
            else:
                np.testing.assert_allclose(g, w, err_msg=f"{path} {name}",
                                           **STEP_TOL)
    hist = [json.loads((exps[n] / "history.json").read_text())
            for n in ("port", "jax")]
    assert hist[0]["steps"] == hist[1]["steps"]
    for key in ("train_loss", "dev_map", "test_map"):
        np.testing.assert_allclose(hist[0][key], hist[1][key], err_msg=key,
                                   **STEP_TOL)

    # the table rank 0 printed is the JAX CLI's eval of the same snapshot
    # (the runs' own snapshots part by the conv biases' noise, which
    # eval-mode BN magnifies: each table is held on one set of weights)
    JCLI.main(["eval", "--data", str(root / "prep"), "--exp",
               str(exps["port"]), "--split", "test"])
    want = _table(capsys.readouterr().out.splitlines())
    got = _table(t_lines)
    assert got.keys() == want.keys() and "map" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4, k
    # every run file is rank 0's; the trec files hold the test split
    for f in ("truth", "result", "history.json", "config.json"):
        assert (exps["port"] / f).exists(), f
    assert (exps["port"] / "config.json").read_text().replace(
        str(exps["port"]), str(exps["jax"])) == \
        (exps["jax"] / "config.json").read_text()


# -------------------------------------------------------------------- solve
def _solver_dir(root, source, model, sub, solver):
    """The recipe's train net at the corpus' widths, as
    ``net_prototxt_from_config`` writes it (HDF5Data over the prepped
    chunks, not shuffled: the packages shuffle with different
    generators; a xavier SimCross filler), and its solver prototxt:
    STEPS iterations, snapshots every EVERY."""
    d = root / sub
    d.mkdir()
    net = net_prototxt_from_config(model, batch_size=BATCH, source=source)
    net = net.replace("shuffle: true", "shuffle: false").replace(
        "sim_cross_param {", 'sim_cross_param { weight_filler { type: '
        '"xavier" }', 1)
    (d / "train.prototxt").write_text(net)
    (d / "solver.prototxt").write_text(solver_prototxt_from_config(
        TrainerConfig(solver=SolverConfig(**SOLVERS[solver]),
                      max_iter=STEPS, test_interval=0,
                      snapshot_interval=EVERY, display=0,
                      snapshot_prefix=str(d / "v4")),
        train_net="train.prototxt"))
    return d


@pytest.mark.parametrize("solver", ["adadelta", "sgd"])
def test_caffe_train_mesh_dp2_under_torchrun_equals_jax(corpus, tmp_path,
                                                        capsys, solver):
    """``solve --mesh-dp 2`` (the generic ``caffe train -gpu 0,1``) on the
    recipe's net over two launched ranks: rank 0 alone prints the last
    iteration and loss and writes the snapshots, which equal the JAX
    CLI's over two devices."""
    root, model = corpus
    source = str(root / "prep" / "train_h5" / "train.txt")
    dirs = {n: _solver_dir(tmp_path, source, model, n, solver)
            for n in ("jax", "port")}
    g0 = JGraphSolver(str(dirs["jax"] / "solver.prototxt"))
    init = str(tmp_path / "init.caffemodel")
    j_save_caffemodel(init, g0.params, g0.state,
                      specs=g0.net.caffemodel_specs(g0.params, g0.state))
    JCLI.main(["solve", "--solver", str(dirs["jax"] / "solver.prototxt"),
               "--weights", init, "--mesh-dp", "2"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    proc = _torchrun(["solve", "--solver",
                      str(dirs["port"] / "solver.prototxt"), "--weights",
                      init, "--mesh-dp", "2"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    printed = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
    assert len(printed) == 1                  # rank 0's line alone
    assert printed[0]["iter"] == want["iter"] == STEPS
    np.testing.assert_allclose(printed[0]["loss"], want["loss"], **STEP_TOL)

    band = _noise_band(solver, STEPS)
    noise = {("conv0", 1), ("conv1", 1), ("bn0", 2), ("bn1", 2)}
    for it in range(EVERY, STEPS + 1, EVERY):
        got, ref = (_parse_layers((dirs[n] / f"v4_iter_{it}.caffemodel")
                                  .read_bytes()) for n in ("port", "jax"))
        assert [n for n, _ in got] == [n for n, _ in ref]
        for (name, blobs), (_, ref_blobs) in zip(got, ref):
            assert len(blobs) == len(ref_blobs), name
            for i, (g, w) in enumerate(zip(blobs, ref_blobs)):
                if (name, i) in noise:
                    assert np.abs(g - w).max() <= band, (it, name, i)
                else:
                    np.testing.assert_allclose(
                        g, w, err_msg=f"{it} {name}[{i}]", **STEP_TOL)


def test_cli_train_mesh_dp2_refuses_a_batch_it_does_not_divide(corpus,
                                                               tmp_path):
    """The recipe's batch over a dp size that does not divide it (here 5
    over 2): the JAX CLI's first step raises (its batch sharded over "dp"
    must divide), and so does each launched rank, naming both sizes; the
    launcher exits with an error and no snapshot is written."""
    root, model = corpus
    trainer = TrainerConfig(solver=SolverConfig(**SOLVERS["sgd"]),
                            max_iter=2, batch_size=5, test_interval=1,
                            snapshot_interval=1,
                            snapshot_dir=str(tmp_path / "models"))
    (tmp_path / "cfg.json").write_text(TConfig.experiment_to_json(model,
                                                                  trainer))
    argv = ["train", "--data", str(root / "prep"), "--exp", str(tmp_path),
            "--config", str(tmp_path / "cfg.json"), "--mesh-dp", "2"]
    with pytest.raises(ValueError, match="divisible by 2, but it is equal "
                                         "to 5"):
        JCLI.main(argv)
    proc = _torchrun(argv)
    assert proc.returncode != 0
    assert proc.stderr.count("ValueError: batch of 5 rows does not split "
                             "over 2 dp ranks") == 2, proc.stderr[-3000:]
    assert not (tmp_path / "models").exists() \
        or not any((tmp_path / "models").iterdir())
