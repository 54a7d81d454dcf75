"""The median of ``fit.eval`` (an eval's replays of the dev split and the
blocking reads of its metrics) over every eval of the run, set-up's
included, from the program's aggregate of the span (its histogram, to
within 1%).  None when the program records no spans."""


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    rec = _recorder()
    evals = None if rec is None else rec.aggregate("fit.eval")
    if evals is None or not run.work.get("steps"):
        return None
    return 1e3 * evals.quantile(0.5)
