"""The median self time of ``engine.query`` over the traced window's
calls: the host's dispatch of a call (the key's lookup, the copy into the
static inputs, the replay's launch, the outputs' clones), which
``engine_call_ms_p50.query`` cannot tell from the device's work and the
fetch.  None when the program records no spans."""

import statistics


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    rec = _recorder()
    if rec is None or not run.work.get("calls"):
        return None
    calls = [s.self_ns for s in rec.spans() if s.name == "engine.query"]
    if not calls:
        return None
    return statistics.median(calls) / 1e6
