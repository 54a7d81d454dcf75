"""The summed seconds of the run's CUDA graph captures, set-up's and any
in the window: each ``graph.capture`` span (the warm-up call, the capture
and the instantiation), from the program's aggregates as the self time of
``graph.capture`` (the capture and the instantiation) and of its child
``graph.warmup`` (the warm-up call), so the kernels' library that a first
warm-up builds or loads (its own span, ``ops.library``) is left out.
None when the program records no spans or captured nothing."""


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    rec = _recorder()
    captures = None if rec is None else rec.aggregate("graph.capture")
    if captures is None or not run.work:
        return None
    warmups = rec.aggregate("graph.warmup")
    return captures.self_s + (0.0 if warmups is None else warmups.self_s)
