"""The share of the traced window that ``GraphSolver.step`` spent getting
its iterations' batches on the host: the summed ``solver.pull`` spans of
the program's latest profiler session (the Data feed's read, parse and
transform where they run in the iteration, or the wait for the batch a
feed reads ahead, and the batch's tensors), over the window.  None when
the program records no spans (the port's ``utils.timer.default``) or the
window holds no pull."""


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    tr, rec = run.device_trace, _recorder()
    if tr is None or tr.window_s <= 0 or rec is None \
            or not run.work.get("traced_iters"):
        return None
    pulls = [s for s in rec.spans() if s.name == "solver.pull"]
    if not pulls:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in pulls) / 1e9 \
        / tr.window_s
