"""The embedding table's gradient, in device ms a training step: the
traced window's device time of the kernels that take it, over the
window's steps.  They are the program's ``embed_grad`` kernels, or aten's
``indexing_backward_kernel`` where the program takes the gradient through
the autograd of ``w[ids]``.  None when the trace or its steps are
missing, when it holds no such kernel, or when the program counts
``embed_grad`` launches and some ``embed_grad`` kernel ran another number
of times in the trace (a launch runs each of its kernels once)."""


def read(run):
    tr, w = run.device_trace, run.work
    if tr is None or not w.get("traced_steps"):
        return None
    seconds = tr.seconds(lambda n: "embed_grad" in n
                         or "indexing_backward" in n)
    if seconds <= 0:
        return None
    launches = run.counters.get("embed_grad")
    if launches is not None and any(
            c != launches for n, c in tr.kernel_n.items()
            if "embed_grad" in n):
        return None
    return 1e3 * seconds / w["traced_steps"]
