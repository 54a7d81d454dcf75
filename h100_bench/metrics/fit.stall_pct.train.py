"""The share of the traced window in which ``Trainer.fit`` stood between
a blocking read and its next launch: the sum, over the program's spans of
the window, of every interval from the end of a read (``fit.read``, the
chunk's losses; ``eval.read``, an eval's metrics) to the start of the next
span that puts work on the card (``chunk.stage``, ``eval.dispatch``),
over the window.  The card has nothing queued in such an interval.  The
stretch before the window's first launch is left out: its read came
before the trace began.  None when the program records no spans (the
port's ``utils.timer.default``), or the window holds no read."""

READS = ("fit.read", "eval.read")
LAUNCHES = ("chunk.stage", "eval.dispatch")


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    tr, rec = run.device_trace, _recorder()
    if tr is None or tr.window_s <= 0 or rec is None \
            or not run.work.get("steps"):
        return None
    spans = sorted((s for s in rec.spans() if s.name in READS + LAUNCHES),
                   key=lambda s: s.start_ns)
    if not any(s.name in READS for s in spans):
        return None
    stalled_ns, since = 0, None
    for s in spans:
        if s.name in READS:
            since = s.end_ns
        elif since is not None:
            stalled_ns += max(0, s.start_ns - since)
            since = None
    return 100.0 * stalled_ns / 1e9 / tr.window_s
