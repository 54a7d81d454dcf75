"""``embed_grad.ms_step.train`` on fake traces: the program's kernels or
aten's, over the traced steps, and None where the trace cannot say."""

import types

import pytest

from h100_bench import run as harness
from h100_bench.trace import DeviceTrace

NAME = "embed_grad.ms_step.train"
OURS = {"embed_grad_tiles_kernel": 0.002, "embed_grad_merge_kernel": 0.003}
ATEN = {"indexing_backward_kernel_float__4_": 0.2428}


def _run(kernel_s, kernel_n=None, counters=None, traced_steps=200):
    trace = DeviceTrace(window_s=0.6, busy_s=0.55,
                        kernel_s=dict(kernel_s, elementwise_kernel=0.028),
                        kernel_n=dict(kernel_n or {}, elementwise_kernel=9))
    return types.SimpleNamespace(
        device_trace=trace, work={"traced_steps": traced_steps},
        counters=counters or {}, home=harness.HERE)


def _read(run):
    return harness.read_metric(NAME, run)


def test_reads_the_programs_kernels_a_step():
    run = _run(OURS, dict.fromkeys(OURS, 400), {"embed_grad": 400})
    assert _read(run) == pytest.approx(1e3 * 0.005 / 200)


def test_reads_atens_scatter_where_the_program_counts_none():
    # the parent's program: no embed_grad counter, aten's kernel
    assert _read(_run(ATEN, {n: 400 for n in ATEN})) == pytest.approx(
        1e3 * 0.2428 / 200)


@pytest.mark.parametrize("run", [
    _run(OURS, {"embed_grad_tiles_kernel": 400,
                "embed_grad_merge_kernel": 399}, {"embed_grad": 400}),
    _run(OURS, dict.fromkeys(OURS, 398), {"embed_grad": 400}),
    _run({}, {}, {"embed_grad": 0}),
    _run(OURS, dict.fromkeys(OURS, 400), {"embed_grad": 400},
         traced_steps=None),
], ids=["a_kernel_dropped", "launches_dropped", "no_kernel", "no_steps"])
def test_none_where_the_trace_cannot_say(run):
    assert _read(run) is None


def test_none_without_a_trace():
    run = _run(OURS)
    run.device_trace = None
    assert _read(run) is None
