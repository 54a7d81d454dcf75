"""The solver cell (``googlenet.solve_lmdb_b32``): its files found by name,
``convnet_flops``, the runner's data and weight layout, its four readers
on synthetic records, a small rehearsal on the CPU (batch 2, six images)
and the controls' readings."""

import time
import types

import numpy as np
import pytest
import torch

from h100_bench import control_solver, convnet_flops
from h100_bench import run as harness
from h100_bench.reference import googlenet as reference
from h100_bench.runners import solver
from h100_bench.trace import DeviceTrace

CELL = "googlenet.solve_lmdb_b32"
MS = 1_000_000


def _run(trace=False, seconds=2.0):
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    run = harness.Run(spec, CELL, 2**31 + 19, seconds, trace, time.time())
    run.config["train_images"] = 6
    run.traffic.update({"batch": 2, "warm_steps": 4, "trace_steps": 3})
    return run


# ------------------------------------------------------------- the files
def test_the_cell_is_found_by_name():
    run = _run()
    assert run.config["name"] == "googlenet"
    assert run.traffic["kind"] == "solver"
    assert harness.runner(run).__file__ == str(
        harness.HERE / "runners" / "solver.py")
    assert [m["name"] for m in run.end_to_end] == ["train_samples_per_s",
                                                   "setup_s"]
    assert [m["name"] for m in run.per_layer] == [
        "mfu.solve", "device_idle_pct.solve", "solver.pull_pct.solve",
        "solver.stall_pct.solve"]
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    (cfg,) = [c for c in spec["configs"] if c["name"] == "googlenet"]
    assert 1 <= len(cfg["source"]) <= 200 and len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        assert key in run.config and key in run.config["reduced_why"]
        assert not key.endswith(("_dim", "_rank", "_size"))


def test_the_configuration_holds_the_prototxts_values():
    cfg = harness.read_json(harness.ROOT / "h100_bench" / "configs"
                            / "googlenet.json")
    solver_text = (harness.ROOT / cfg["solver"]).read_text()
    for key, value in cfg["sgd"].items():
        want = f'"{value}"' if isinstance(value, str) else repr(value)
        assert f"{key}: {want}\n" in solver_text, key
    assert "test_iter" not in solver_text and "test_interval" not in \
        solver_text
    net = (harness.ROOT / cfg["net"]).read_text()
    assert solver._source(net) == ("ilsvrc12_train_lmdb", 32)
    assert {k: tuple(v) for k, v in cfg["inception"].items()} == \
        reference.INCEPTION


# ------------------------------------------------------- convnet_flops
def test_googlenet_counts():
    text = (harness.ROOT / "h100_bench/configs/googlenet/train_val.prototxt"
            ).read_text()
    count = convnet_flops.forward_macs(text)
    assert count["total"] == 1_591_044_096
    assert len(count["by_layer"]) == 64
    assert count["blobs"]["pool5/7x7_s1"] == (1024, 1, 1)
    assert count["blobs"]["loss2/ave_pool"] == (528, 4, 4)
    # the reference's layer list holds the same work
    macs = 0
    for name, kind, shape in reference.layers():
        macs += count["by_layer"][name]
        if kind == "fc":
            assert count["by_layer"][name] == shape[0] * shape[1]
    assert macs == count["total"]
    assert convnet_flops.train_flops(text) == 6 * 1_591_044_096
    test = convnet_flops.forward_macs(text, phase="TEST")
    assert test["total"] == count["total"]


def test_small_nets_ceil_pooling_and_unknown_layers():
    net = """
    layer { name: "in" type: "Data" top: "x" top: "y"
      transform_param { crop_size: 9 } }
    layer { name: "c" type: "Convolution" bottom: "x" top: "c"
      convolution_param { num_output: 4 kernel_size: 3 stride: 2 } }
    layer { name: "p" type: "Pooling" bottom: "c" top: "p"
      pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
    layer { name: "f" type: "InnerProduct" bottom: "p" top: "f"
      inner_product_param { num_output: 7 } }
    """
    count = convnet_flops.forward_macs(net)
    assert count["blobs"]["c"] == (4, 4, 4)
    assert count["blobs"]["p"] == (4, 2, 2)        # ceil((4 - 3) / 2) + 1
    assert count["by_layer"] == {"c": 4 * 3 * 9 * 16, "f": 16 * 7}
    with pytest.raises(ValueError, match="Deconvolution"):
        convnet_flops.forward_macs(net + 'layer { name: "d" type: '
                                   '"Deconvolution" bottom: "f" top: "d" }')


# ------------------------------------------------- data and weight layout
def test_a_datum_reads_back_through_the_program():
    from mms_answer_selection_tpu_torch.utils.io import (datum_label,
                                                         datum_to_array)

    pixels, labels = solver.images(5, 3, 1000, "cpu")
    assert pixels.dtype == torch.uint8 and pixels.shape == (3, 3, 256, 256)
    again = solver.images(5, 3, 1000, "cpu")
    assert torch.equal(again[0], pixels) and torch.equal(again[1], labels)
    for i in range(3):
        raw = solver.datum(pixels[i].numpy(), int(labels[i]))
        assert np.array_equal(datum_to_array(raw), pixels[i].numpy())
        assert datum_label(raw) == int(labels[i])


def test_the_weights_land_in_the_programs_layout():
    """An inner product's Caffe (out, C*H*W) weight, laid out for an NHWC
    blob, computes the same product."""
    w = torch.randn(5, 128 * 4 * 4, dtype=torch.float64)
    x = torch.randn(2, 128, 4, 4, dtype=torch.float64)
    mine = solver.to_program({"loss1/fc": {"w": w, "b": torch.zeros(5)}})
    got = x.permute(0, 2, 3, 1).reshape(2, -1) @ mine["loss1/fc"]["w"]
    assert torch.allclose(got, x.flatten(1) @ w.t())
    conv = torch.randn(8, 3, 7, 7)
    assert solver.to_program({"c": {"w": conv, "b": torch.zeros(8)}})[
        "c"]["w"].shape == (7, 7, 3, 8)


# ------------------------------------------------------------ the readers
def _spans(*named):
    return [types.SimpleNamespace(name=n, start_ns=int(a * MS),
                                  end_ns=int(b * MS)) for n, a, b in named]


class _Record:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


def _fake(monkeypatch, spans):
    from mms_answer_selection_tpu_torch.utils import timer

    monkeypatch.setattr(timer, "default", _Record(spans))


def _traced(window_s=0.1, busy_s=0.03, iters=4):
    run = _run(trace=True)
    run.device_trace = DeviceTrace(window_s=window_s, busy_s=busy_s)
    run.work = {"iters": iters, "traced_iters": iters, "batch": 32,
                "window_s": 1.0}
    return run


def test_readers_on_synthetic_records(monkeypatch):
    run = _traced()
    # two iterations: pull 0-30 ms, stage 30-32, replay 32-33, read 33-45;
    # then pull 45-70, stage 70-71, replay, read 72-80
    _fake(monkeypatch, _spans(
        ("solver.pull", 0, 30), ("chunk.stage", 30, 32),
        ("chunk.replay", 32, 33), ("solver.read", 33, 45),
        ("solver.pull", 45, 70), ("chunk.stage", 70, 71),
        ("chunk.replay", 71, 72), ("solver.read", 72, 80)))
    read = lambda name: harness.read_metric(name, run)   # noqa: E731
    assert read("solver.pull_pct.solve") == pytest.approx(55.0)
    assert read("solver.stall_pct.solve") == pytest.approx(25.0)
    assert read("device_idle_pct.solve") == pytest.approx(70.0)
    flops = 4 * 32 * 6 * 1_591_044_096
    assert read("mfu.solve") == pytest.approx(
        100 * flops / (0.1 * 495e12 / 3))


def test_readers_return_none_without_spans_or_trace(monkeypatch):
    run = _traced()
    _fake(monkeypatch, _spans(("chunk.stage", 0, 1), ("chunk.replay", 1, 2)))
    for name in ("solver.pull_pct.solve", "solver.stall_pct.solve"):
        assert harness.read_metric(name, run) is None
    from mms_answer_selection_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "default")            # a program without
    assert harness.read_metric("solver.pull_pct.solve", run) is None
    run.device_trace = None
    for m in run.per_layer:
        assert harness.read_metric(m["name"], run) is None


# ---------------------------------------------------- a rehearsal, controls
def test_a_small_run_on_the_cpu_is_correct_and_traced():
    torch.set_num_threads(4)
    run = _run(trace=True, seconds=4.0)
    run.traffic["trace_steps"] = 2
    run.device = torch.device("cpu")
    harness.runner(run).measure(run, run.device)
    out = harness.result(run, {"platform": "cpu"})
    assert out["correct"], out["checks"]
    assert run.work["batch"] == 2 and 1 <= run.work["traced_iters"] <= 2
    assert run.failed == 0 and run.attempted == run.work["iters"]
    # the CPU runs no device activity: the idle share reads nothing
    assert set(out["metrics"]) == {m["name"] for m in run.per_layer} - {
        "device_idle_pct.solve"}
    assert 0 < out["metrics"]["solver.pull_pct.solve"]["value"] < 100
    # a stall needs a read and the next stage inside the trace: two traced
    # iterations, which a loaded host may not fit in the window
    assert 0 <= out["metrics"]["solver.stall_pct.solve"]["value"] < 100


@pytest.mark.parametrize("mode", sorted(control_solver.MODES))
def test_controls_read_on_the_cpu(mode):
    """Each control, judged with the mix's limits, is not correct; TF32
    exists only on the card, so on the CPU its control is the reference
    itself and reads nothing."""
    torch.set_num_threads(4)
    run = _run()
    out = control_solver.readings(run, torch.device("cpu"), mode, batch=2)
    assert set(out) == {"loss_gap", "grad_gap", "median_change_gap"}
    assert all(np.isfinite(v) for v in out.values())
    if mode == "control":
        assert out == {k: 0.0 for k in out}
    else:
        assert not control_solver.correct(run, out), out


@pytest.mark.cuda
def test_tf32_control_on_the_card():
    """The TF32 control at the cell's own sizes reads ``correct: false``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    run = harness.Run(spec, CELL, 2**31 + 5, 0.0, False, time.time())
    out = control_solver.readings(run, torch.device("cuda"), "control")
    assert not control_solver.correct(run, out), out


# ------------------------------------------- faults planted in the program
def _half_batch(monkeypatch):
    """Each iteration steps on the first half of its batch."""
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver

    step = GraphSolver._graph_step

    def half(self, params, state, opt_state, batch, it, generators):
        batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return step(self, params, state, opt_state, batch, it, generators)

    monkeypatch.setattr(GraphSolver, "_graph_step", half)


def _unchanged(monkeypatch):
    """Each iteration hands back the weights and SGD's history it got."""
    from mms_answer_selection_tpu_torch.training.graph_solver import \
        GraphSolver

    step = GraphSolver._graph_step

    def unchanged(self, params, state, opt_state, batch, it, generators):
        out = step(self, params, state, opt_state, batch, it, generators)
        return (params, state, opt_state) + tuple(out[3:])

    monkeypatch.setattr(GraphSolver, "_graph_step", unchanged)


def _zeroed_branch(monkeypatch):
    """Inception 4e's pool projection puts out zeros."""
    from mms_answer_selection_tpu_torch.models import graph_net

    entry = graph_net._REGISTRY["Convolution"]

    def conv(ctx, node, bottoms):
        y = entry.fn(ctx, node, bottoms)
        return torch.zeros_like(y) if node.name == \
            "inception_4e/pool_proj" else y

    monkeypatch.setitem(graph_net._REGISTRY, "Convolution",
                        graph_net._Entry(conv, entry.param_keys))


@pytest.mark.parametrize("plant", [_half_batch, _unchanged, _zeroed_branch],
                         ids=["half_batch", "unchanged", "zeroed_branch"])
def test_a_fault_planted_in_the_solver_is_not_correct(plant, monkeypatch):
    """The runner's own set-up, window and check over a GraphSolver with
    the fault: ``correct`` is false."""
    torch.set_num_threads(4)
    plant(monkeypatch)
    run = _run(seconds=1.0)
    run.device = torch.device("cpu")
    harness.runner(run).measure(run, run.device)
    assert not run.correct, run.checks
