"""The device time of the traced window's kernels other than MaxSim (the
queries' projection, each chunk's top-k and their merge), per call: the
summed device time of the names without ``maxsim``, over the calls the
program's ``engine.query`` spans counted in the window.  None when the
trace or the spans are missing."""


def _recorder():
    from mms_answer_selection_tpu_torch.utils import timer

    return getattr(timer, "default", None)


def read(run):
    tr, rec = run.device_trace, _recorder()
    if tr is None or rec is None or not run.work.get("calls"):
        return None
    calls = sum(s.name == "engine.query" for s in rec.spans())
    if not calls:
        return None
    return 1e3 * tr.seconds(lambda n: "maxsim" not in n) / calls
