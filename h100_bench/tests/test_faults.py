"""``correct`` on small CPU runs of each kind of cell: true for the sound
program, false with the timed path broken underneath, and false for the
control (the reference in the precision below the configuration's, in
the program's place).  The limits are the traffic files' own."""

import pytest
import torch

from h100_bench import control

from .cells import measure, small_run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


QUERY_CELLS = ["v4.query_1m_int8_b256", "v4_wide.query_262k_bf16_b256"]
TRAIN_CELLS = ["v4.train_recipe_b50"]


@pytest.mark.parametrize("workload", QUERY_CELLS + TRAIN_CELLS)
def test_the_sound_program_is_correct(workload):
    run = measure(small_run(workload))
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("workload", QUERY_CELLS)
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    from mms_answer_selection_tpu_torch.serve.query_engine import QueryEngine

    query = QueryEngine.query

    def altered(self, q, k=10):
        vals, idx = query(self, q, k=k)
        idx = idx.clone()
        idx[:, 0] = (idx[:, 0] + 1) % self.pool_size
        return vals, idx

    monkeypatch.setattr(QueryEngine, "query", altered)
    run = measure(small_run(workload))
    assert not run.correct, run.checks


def _broken_step(monkeypatch, how):
    from mms_answer_selection_tpu_torch.training.trainer import Trainer

    step = Trainer._train_step

    def broken(self, params, state, opt_state, batch, it, generators=None):
        if how == "half_batch":
            n = next(iter(batch.values())).shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        out = step(self, params, state, opt_state, batch, it,
                   generators=generators)
        if how == "unchanged":
            return (params, state, opt_state) + tuple(out[3:])
        return out

    monkeypatch.setattr(Trainer, "_train_step", broken)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_a_broken_training_step(workload, how, monkeypatch):
    _broken_step(monkeypatch, how)
    run = measure(small_run(workload))
    assert not run.correct, run.checks


@pytest.mark.parametrize("workload", QUERY_CELLS)
@pytest.mark.parametrize("mode", ["control", "answer_altered"])
def test_controls_of_retrieval_are_not_correct(workload, mode):
    run = small_run(workload)
    readings = control.readings(run, torch.device("cpu"), mode)
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_half_batch_in_the_references_place_is_not_correct(workload):
    run = small_run(workload)
    readings = control.readings(run, torch.device("cpu"), "half_batch")
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_tf32_training_control_on_the_card(workload):
    """TF32 exists only on the card: the control of a float32 cell at the
    cell's own sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h100_bench import run as harness
    import time

    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    run = harness.Run(spec, workload, 2**31 + 3, 0.0, False, time.time())
    readings = control.readings(run, torch.device("cuda"), "control")
    limits = run.traffic["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings
