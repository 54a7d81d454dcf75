"""The port's spans and counters (``utils/timer.py``'s ``Recorder``) on the
CPU: aggregates alone without a profiler, the spans whole and on the
profiler's clock under one, and where the port opens them: ``Trainer.fit``'s
chunk, read and eval boundaries, ``QueryEngine.query``'s dispatch and
``QAServer``'s requests, each server counting on its own recorder."""

import statistics
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mms_answer_selection_tpu_torch.models.mms_qa import (ConvBlock,
                                                          MMSQAConfig)
from mms_answer_selection_tpu_torch.serve import QAServer, QueryEngine
from mms_answer_selection_tpu_torch.training import (SolverConfig, Trainer,
                                                     TrainerConfig)
from mms_answer_selection_tpu_torch.utils import timer
from mms_answer_selection_tpu_torch.utils.timer import Recorder


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder, so other tests' spans stay out."""
    rec = Recorder()
    monkeypatch.setattr(timer, "default", rec)
    return rec


def _busy(n: int) -> None:
    sum(range(n))


# ------------------------------------------------------------- the recorder
def test_without_a_profiler_only_aggregates_are_kept():
    rec = Recorder()
    with rec.span("outer") as outer:
        with rec.span("inner") as a:
            _busy(20_000)
        _busy(5_000)
        with rec.span("inner") as b:
            _busy(20_000)
    rec.count("things")
    rec.count("things", 4)
    assert rec.spans() == []
    assert rec.counter("things") == 5 and rec.counter("nothing") == 0
    assert rec.aggregate("missing") is None
    inner, top = rec.aggregate("inner"), rec.aggregate("outer")
    assert (inner.count, top.count) == (2, 1)
    assert inner.total_ns == inner.self_ns == (
        a.end_ns - a.start_ns + b.end_ns - b.start_ns)
    assert top.total_ns == outer.end_ns - outer.start_ns
    assert top.self_ns == top.total_ns - inner.total_ns > 0
    assert (a.parent, b.parent, outer.parent) == (outer.seq, outer.seq, None)
    assert a.id == b.id == outer.id == outer.seq


def test_the_histogram_holds_the_median_of_600_spans_within_2_percent():
    rec = Recorder()
    rng = np.random.default_rng(3)
    seconds = []
    for n in rng.integers(1_000, 60_000, 600):
        with rec.span("work") as s:
            _busy(int(n))
        seconds.append(s.seconds)
    agg = rec.aggregate("work")
    assert agg.count == 600
    want = sorted(seconds)[300]         # rank int(600 * 0.5), as /stats
    assert abs(agg.quantile(0.5) - want) <= 0.02 * want
    assert abs(agg.quantile(0.9) - sorted(seconds)[540]) \
        <= 0.02 * sorted(seconds)[540]
    assert abs(agg.total_s - sum(seconds)) <= 1e-6 * sum(seconds)
    assert statistics.median(seconds) > 0


def test_a_span_left_by_an_exception_joins_no_aggregate():
    rec = Recorder()
    with pytest.raises(ValueError):
        with rec.span("outer"):
            with rec.span("fails"):
                raise ValueError("x")
    assert rec.aggregate("fails") is None and rec.aggregate("outer") is None
    with rec.span("after") as s:
        pass
    assert s.parent is None                  # the stack was unwound


def test_under_the_profiler_spans_are_kept_whole_on_its_clock():
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("first"):     # a session's first mirror sets it up
            pass
        for i in range(5):
            with rec.span("unit", id=100 + i):
                with rec.span("unit.part"):
                    torch.ones(4).add_(1)
        late = rec.span("late")
        late.__enter__()
    late.__exit__(None, None, None)          # closed after the session
    spans = rec.spans()
    assert [s.name for s in spans] == \
        ["first"] + ["unit.part", "unit"] * 5 + ["late"]
    units = [s for s in spans if s.name == "unit"]
    parts = [s for s in spans if s.name == "unit.part"]
    assert [s.id for s in units] == [s.id for s in parts] == \
        list(range(100, 105))
    assert all(p.parent == u.seq for p, u in zip(parts, units))
    assert rec.aggregate("unit").count == 5
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for name, mine in (("unit", units), ("unit.part", parts)):
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(theirs) == 5
        for s, e in zip(mine, theirs):
            assert abs(e.start_ns() - s.start_ns) < 100_000, name
            assert abs(e.end_ns() - s.end_ns) < 100_000, name


def test_a_new_profiler_session_starts_the_spans_anew():
    """The spans kept whole are the latest session's: a span opened with
    no profiler between two sessions ends the first."""
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with rec.span("first"):
                pass
    assert [s.name for s in rec.spans()] == ["first"] * 3
    with rec.span("between"):
        pass
    assert [s.name for s in rec.spans()] == ["first"] * 3   # until read
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("second"):
            pass
    assert [s.name for s in rec.spans()] == ["second"]
    assert rec.aggregate("first").count == 3            # aggregates stay
    assert all(s._mirror is None for s in rec.spans())  # handles let go


def test_threads_keep_their_own_stacks_and_lose_no_update():
    rec = Recorder()
    nested, read = [], []
    done = threading.Event()

    def work():
        for _ in range(200):
            with rec.span("outer"):
                with rec.span("inner") as s:
                    rec.count("n")
                nested.append(s.parent is not None)

    def reader():           # /stats reads while requests close spans
        while not done.is_set():
            agg = rec.aggregate("inner")
            if agg is not None:
                read.append(agg.quantile(0.9))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        watcher = threading.Thread(target=reader)
        watcher.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        watcher.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads + [watcher])
    assert all(nested) and len(nested) == 16 * 200
    assert rec.counter("n") == 16 * 200
    assert rec.aggregate("outer").count == rec.aggregate("inner").count \
        == 16 * 200
    assert sum(rec.aggregate("inner").buckets.values()) == 16 * 200
    assert read and all(r > 0 for r in read)


# ------------------------------------------------------------ Trainer.fit
def _tiny_fit_data(n: int, groups: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"question": rng.integers(0, 60, (n, 8)).astype(np.int32),
            "answer": rng.integers(0, 60, (n, 8)).astype(np.int32),
            "overlap_feat": rng.random((n, 2)).astype(np.float32),
            "label": (np.arange(n) % 3 == 0).astype(np.int32),
            "group": np.repeat(np.arange(groups), n // groups).astype(
                np.int32)}


def test_fit_opens_the_chunk_spans_in_order(recorder):
    cfg = MMSQAConfig(vocab_size=60, embed_dim=6, question_len=8,
                      answer_len=8, sim_measures=2,
                      blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),),
                      fc1_dim=4, sim_weight_init="xavier")
    tcfg = TrainerConfig(solver=SolverConfig(solver_type="adadelta",
                                             base_lr=1.0, momentum=0.95,
                                             delta=5e-7),
                         max_iter=12, batch_size=4, test_interval=10,
                         train_loss_record_interval=1, seed=5)
    trainer = Trainer(cfg, tcfg, device="cpu")
    train, dev = _tiny_fit_data(24, 6, 1), _tiny_fit_data(12, 3, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        history = trainer.fit(train, dev, steps_per_dispatch=5)
    assert history["steps"] == [0, 10]
    spans = recorder.spans()
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    assert names[:2] == ["fit.init", "fit.upload"]
    chunk = ["fit.chunk", "fit.pull", "chunk.stage", "chunk.replay",
             "fit.read", "fit.steps"]
    evaluated = chunk + ["fit.eval", "eval.dispatch", "eval.read"]
    # chunks of steps 0, 1-5, 6-10 and 11; evals at steps 0 and 10
    assert names[2:] == evaluated + chunk + evaluated + chunk
    chunks = {s.seq: s for s in spans if s.name == "fit.chunk"}
    assert [s.id for s in chunks.values()] == [0, 1, 6, 11]
    inner = [s for s in spans if s.parent in chunks]
    assert len(inner) == 5 * 4
    assert all(s.id == chunks[s.parent].id for s in inner)
    steps = {s.seq: s for s in spans if s.name == "fit.steps"}
    evals = [s for s in spans if s.name == "fit.eval"]
    assert [steps[e.parent].id for e in evals] == [0, 6]
    assert [e.id for e in evals] == [0, 6]
    assert all(steps[e.parent].start_ns <= e.start_ns
               and e.end_ns <= steps[e.parent].end_ns for e in evals)
    assert recorder.aggregate("fit.read").count == 4
    assert recorder.aggregate("eval.read").count == 2
    assert recorder.aggregate("graph.capture") is None  # eager on the CPU


def test_fit_without_a_profiler_keeps_counts_only(recorder):
    cfg = MMSQAConfig(vocab_size=60, embed_dim=6, question_len=8,
                      answer_len=8, sim_measures=2,
                      blocks=(ConvBlock(3, 3, 4, "ave", 2, 2),),
                      fc1_dim=4, sim_weight_init="xavier")
    tcfg = TrainerConfig(max_iter=7, batch_size=4, test_interval=5, seed=5)
    Trainer(cfg, tcfg, device="cpu").fit(
        _tiny_fit_data(24, 6, 1), _tiny_fit_data(12, 3, 2),
        steps_per_dispatch=5)
    assert recorder.spans() == []
    assert recorder.aggregate("chunk.replay").count == 3     # 0, 1-5, 6
    assert recorder.aggregate("fit.eval").count == 2
    assert recorder.aggregate("fit.read").count == 3
    assert recorder.aggregate("eval.read").count == 2


# ------------------------------------------------------------ the engine
def _engine():
    cfg = MMSQAConfig(vocab_size=50, embed_dim=8, question_len=6,
                      answer_len=6, sim_measures=2)
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"w": torch.rand(50, 8, generator=g) - 0.5,
                        "b": torch.rand(8, generator=g) - 0.5},
              "sim": {"w": torch.rand(2, 8, 8, generator=g) - 0.5}}
    ids = torch.randint(0, 50, (40, 6), generator=g)
    engine = QueryEngine(params, cfg, chunk_size=16, device="cpu")
    return engine.build_index(ids), torch.randint(0, 50, (3, 6),
                                                  generator=g)


def test_query_opens_one_engine_span_a_call(recorder):
    engine, q = _engine()
    for _ in range(3):
        engine.query(q, k=4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            engine.query(q, k=4)
    agg = recorder.aggregate("engine.query")
    assert agg.count == 5 and agg.self_ns <= agg.total_ns
    raw = recorder.spans()
    assert [s.name for s in raw] == ["engine.query"] * 2
    assert raw[0].id != raw[1].id


# ------------------------------------------------------------ the server
class _StubEngine:
    """What ``QAServer`` reads of an engine; ``query`` sleeps ``slow``
    seconds on its first ``slow_calls`` calls."""

    def __init__(self, slow_calls: int = 0, slow: float = 0.0):
        self.cfg = types.SimpleNamespace(question_len=4, answer_len=4,
                                         vocab_size=20)
        self.pool_size = self.n_live = 8
        self.pool_dtype, self.ivf = "bf16", None
        self.calls, self.slow_calls, self.slow = 0, slow_calls, slow

    def query(self, q, k):
        self.calls += 1
        if self.calls <= self.slow_calls:
            time.sleep(self.slow)
        n = len(q)
        return (torch.zeros(n, k), torch.arange(k).repeat(n, 1))


def test_two_servers_count_apart():
    a, b = QAServer(_StubEngine()), QAServer(_StubEngine())
    try:
        for n in (1, 3, 2):
            a.handle_query({"tokens": [[1, 2]] * n, "k": 2})
        sa, sb = a.stats.snapshot(), b.stats.snapshot()
        assert sa["queries_served"] == 3 and sa["query_rows"] == 6
        assert sa["device_dispatches"] == 3
        assert sa["device_dispatch_rows"] == 1 + 4 + 2     # padded buckets
        assert "p50_ms" in sa and "p90_ms" in sa
        assert sb == {"queries_served": 0, "query_rows": 0, "errors": 0,
                      "device_dispatches": 0, "device_dispatch_rows": 0}
        assert a.recorder.aggregate("server.dispatch").count == 3
        assert b.recorder.aggregate("server.request") is None
    finally:
        a.close()
        b.close()


def test_stats_keep_every_request_since_start():
    """600 requests whose first 100 are slow: the 90th percentile is a
    slow one, which a window of the last 512 would have dropped."""
    srv = QAServer(_StubEngine(slow_calls=100, slow=0.01))
    try:
        for _ in range(600):
            srv.handle_query({"tokens": [[1, 2, 3]], "k": 2})
        stats = srv.stats.snapshot()
        assert stats["queries_served"] == 600
        assert stats["p90_ms"] >= 10.0 > stats["p50_ms"]
    finally:
        srv.close()


def test_batched_requests_wait_in_the_queue_span():
    srv = QAServer(_StubEngine(), batch_window_ms=20.0)
    try:
        threads = [threading.Thread(target=srv.handle_query,
                                    args=({"tokens": [[1, 2]], "k": 2},))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        rec, stats = srv.recorder, srv.stats.snapshot()
        assert stats["queries_served"] == 3
        assert rec.aggregate("server.request").count == 3
        assert rec.aggregate("server.queue").count == 3
        assert 1 <= rec.aggregate("server.dispatch").count \
            == stats["device_dispatches"] <= 3
        # a request's wait holds its group's call
        assert rec.aggregate("server.queue").total_ns \
            >= rec.aggregate("server.dispatch").total_ns
    finally:
        srv.close()
