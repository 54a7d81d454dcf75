"""The share of the traced window in which ``GraphSolver.step`` stood
between a blocking read and its next launch, as ``fit.stall_pct.train``
measures it: the sum, over the program's spans of the window, of every
interval from the end of a ``solver.read`` (the iteration's loss and
outputs read back) to the start of the next ``chunk.stage`` (the next
iteration's batch staged for its replay), over the window.  The card has
nothing queued in such an interval; the next iteration's pull lies in it.
None when the program records no spans, or the window holds no read."""

READ, LAUNCH = "solver.read", "chunk.stage"


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    tr, rec = run.device_trace, _recorder()
    if tr is None or tr.window_s <= 0 or rec is None \
            or not run.work.get("traced_iters"):
        return None
    spans = sorted((s for s in rec.spans() if s.name in (READ, LAUNCH)),
                   key=lambda s: s.start_ns)
    if not any(s.name == READ for s in spans):
        return None
    stalled_ns, since = 0, None
    for s in spans:
        if s.name == READ:
            since = s.end_ns
        elif since is not None:
            stalled_ns += max(0, s.start_ns - since)
            since = None
    return 100.0 * stalled_ns / 1e9 / tr.window_s
