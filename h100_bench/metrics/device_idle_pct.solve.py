"""The share of the traced window in which no device activity ran, in the
solver cell: 1 - (the union of kernel, copy and set intervals) / the
window."""


def read(run):
    tr = run.device_trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
