"""The share of rank 0's traced window in which an NCCL kernel ran (the
union of their intervals): the gradient all-reduce and BN's sums.  None
on one card."""


def read(run):
    tr = run.device_trace
    if tr is None or run.work.get("ranks", 1) < 2 or tr.window_s <= 0:
        return None
    return 100.0 * tr.union_s.get("nccl", 0.0) / tr.window_s
