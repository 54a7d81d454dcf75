"""The readers of the program's own spans (``metrics/fit.*``,
``graph.capture_s``, ``engine.*``) on synthetic runs and records, on
small traced runs on the CPU, and returning None where a run or the
program holds no spans."""

import types

import pytest
import torch

from h100_bench import run as harness
from h100_bench.trace import DeviceTrace
from mms_answer_selection_tpu_torch.utils import timer
from mms_answer_selection_tpu_torch.utils.timer import Aggregate, Recorder

from .cells import measure, small_run

MS = 1_000_000                                   # ns


class _Record:
    """A recorder's face to the readers: spans and aggregates as given."""

    def __init__(self, spans=(), aggregates=None):
        self._spans, self._aggregates = list(spans), aggregates or {}

    def spans(self):
        return list(self._spans)

    def aggregate(self, name):
        return self._aggregates.get(name)


def _span(name, start_ms, end_ms, self_ms=None):
    return types.SimpleNamespace(
        name=name, start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
        self_ns=int((end_ms - start_ms if self_ms is None else self_ms) * MS))


def _aggregate(*ms, child_ms=0):
    agg = Aggregate()
    for m in ms:
        agg.add(int(m * MS), int((m - child_ms) * MS))
    return agg


def _run(window_s=0.1, kernel_s=None, **work):
    trace = DeviceTrace(window_s=window_s, busy_s=window_s / 2,
                        kernel_s=kernel_s or {})
    return types.SimpleNamespace(device_trace=trace, work=work,
                                 home=harness.HERE)


def _read(name, run):
    return harness.read_metric(name, run)


TRAIN = {"steps": 200}
QUERY = {"calls": 3}


def test_stall_sums_each_read_to_the_next_launch(monkeypatch):
    spans = [_span("fit.pull", 0, 4), _span("chunk.stage", 4, 5),
             _span("chunk.replay", 5, 6), _span("fit.read", 6, 10),
             _span("fit.steps", 10, 30), _span("fit.eval", 12, 24),
             _span("eval.dispatch", 15, 16), _span("eval.read", 16, 20),
             _span("fit.pull", 22, 25), _span("chunk.stage", 26, 27),
             _span("chunk.replay", 27, 28), _span("fit.read", 28, 40),
             _span("fit.steps", 40, 41), _span("chunk.stage", 41, 42),
             _span("fit.read", 50, 60)]             # no launch after it
    monkeypatch.setattr(timer, "default", _Record(spans))
    # (15 - 10) + (26 - 20) + (41 - 40) ms of a 100 ms window
    assert _read("fit.stall_pct.train", _run(0.1, **TRAIN)) == \
        pytest.approx(12.0)


def test_aggregates_read_as_the_eval_median_and_the_capture_sum(
        monkeypatch):
    rec = _Record(aggregates={"fit.eval": _aggregate(10, 20, 30, 1000),
                              "graph.capture": _aggregate(500, 1000,
                                                          child_ms=100),
                              "graph.warmup": _aggregate(60, 40,
                                                         child_ms=20)})
    monkeypatch.setattr(timer, "default", rec)
    eval_ms = _read("fit.eval_ms_p50.train", _run(**TRAIN))
    assert eval_ms == pytest.approx(30, rel=0.01)    # rank int(4 * 0.5)
    # the captures' self time and the warm-ups', less the library build
    # nested in each warm-up
    assert _read("graph.capture_s", _run(**TRAIN)) == pytest.approx(1.36)


def test_engine_reads_take_the_window_calls(monkeypatch):
    calls = [_span("engine.query", 0, 10, self_ms=0.1),
             _span("engine.query", 10, 20, self_ms=0.3),
             _span("engine.query", 20, 30, self_ms=0.2),
             _span("graph.capture", 0, 5)]
    monkeypatch.setattr(timer, "default", _Record(calls))
    run = _run(kernel_s={"maxsim::maxsim_kernel_1": 5.0,
                         "at::native::mbtopk::gatherTopK": 0.2,
                         "at::native::elementwise_kernel": 0.1}, **QUERY)
    assert _read("engine.host_ms_p50.query", run) == pytest.approx(0.2)
    assert _read("engine.non_maxsim_ms.query", run) == pytest.approx(100.0)


NEW = ("fit.stall_pct.train", "fit.eval_ms_p50.train", "graph.capture_s",
       "engine.host_ms_p50.query", "engine.non_maxsim_ms.query")


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(monkeypatch, name):
    full = _run(kernel_s={"topk": 1.0}, **TRAIN, **QUERY)
    monkeypatch.setattr(timer, "default", _Record())
    assert _read(name, full) is None                 # nothing recorded
    monkeypatch.delattr(timer, "default")
    assert _read(name, full) is None                 # no recorder at all
    monkeypatch.setattr(timer, "default", _Record(
        [_span("fit.read", 0, 1), _span("engine.query", 0, 1)],
        {"fit.eval": _aggregate(1), "graph.capture": _aggregate(1)}),
        raising=False)
    empty = types.SimpleNamespace(device_trace=None, work={},
                                  home=harness.HERE)
    assert _read(name, empty) is None                # the run measured none


@pytest.mark.parametrize("cell", ["v4.train_recipe_b50",
                                  "v4.query_1m_int8_b256"])
def test_small_traced_runs_read_the_program_spans(monkeypatch, cell):
    rec = Recorder()
    monkeypatch.setattr(timer, "default", rec)
    torch.set_num_threads(2)
    run = measure(small_run(cell, trace=True))
    out = harness.result(run, {"platform": "cpu"})
    assert out["correct"]
    got = {m["name"]: out["metrics"].get(m["name"], {}).get("value")
           for m in run.per_layer if m["name"] in NEW}
    if run.traffic["kind"] == "train":
        # eager on the CPU: no capture; one stall interval a chunk at least
        assert set(got) == {"fit.stall_pct.train", "fit.eval_ms_p50.train",
                            "graph.capture_s"}
        assert 0 < got["fit.stall_pct.train"] < 100
        assert got["fit.eval_ms_p50.train"] > 0
        assert got["graph.capture_s"] is None
        assert rec.aggregate("fit.read").count > 0
    else:
        assert set(got) == {"graph.capture_s", "engine.host_ms_p50.query",
                            "engine.non_maxsim_ms.query"}
        assert got["engine.host_ms_p50.query"] > 0
        assert got["engine.non_maxsim_ms.query"] == 0.0   # no device
        raw = [s for s in rec.spans() if s.name == "engine.query"]
        assert len(raw) == run.work["calls"]
