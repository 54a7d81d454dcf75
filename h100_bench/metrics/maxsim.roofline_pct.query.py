"""The window's MaxSim launches at their roofline: the summed bound of
every launch (``roofline.maxsim_bound_s``: each call scores the pool
chunk by chunk, one launch a chunk), over their summed device time in the
trace.  None when the trace holds no MaxSim kernel, or not the launches
the program counted (a share whose time misses launches would read
high)."""

from h100_bench import roofline


def read(run):
    tr, w, cfg = run.device_trace, run.work, run.config
    if tr is None or not w.get("calls"):
        return None
    maxsim = lambda n: "maxsim" in n                    # noqa: E731
    seconds, traced = tr.seconds(maxsim), tr.count(maxsim)
    launched = sum(v for k, v in run.counters.items()
                   if k.startswith("maxsim"))
    chunk = int(run.traffic["chunk_size"])
    sizes = [min(chunk, w["pool"] - a) for a in range(0, w["pool"], chunk)]
    if seconds <= 0 or traced != launched \
            or launched != w["calls"] * len(sizes):
        return None
    bound = w["calls"] * sum(roofline.maxsim_bound_s(
        w["batch"], c, cfg["embed_dim"], cfg["question_len"],
        cfg["answer_len"], cfg["sim_measures"], w["pool_dtype"])[0]
        for c in sizes)
    return 100.0 * bound / seconds
