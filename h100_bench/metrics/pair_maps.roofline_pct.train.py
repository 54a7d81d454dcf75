"""The traced window's pair-map launches at their roofline: the summed
bound (``roofline.pair_maps_bound_s``, 3xTF32 for float32-accurate
products) of each step's forward, dQ/dA and dW at the local batch and of
each dev eval's forward at the split's rows, over the device time of the
pair-map kernels (dW's partial-sum pass included).  None when the trace
holds none, or not the launches the program counted."""

from h100_bench import roofline


def read(run):
    tr, w, cfg = run.device_trace, run.work, run.config
    if tr is None or not w.get("traced_steps"):
        return None
    ours = lambda n: "pair_maps" in n or "sum_partials" in n  # noqa: E731
    seconds = tr.seconds(ours)
    steps, evals = w["traced_steps"], w["traced_evals"]
    c = run.counters
    if seconds <= 0 or c.get("pair_maps_fwd") != steps + evals \
            or c.get("pair_maps_bwd_qa") != steps \
            or c.get("pair_maps_bwd_w") != steps:
        return None
    dims = (cfg["embed_dim"], cfg["question_len"], cfg["answer_len"],
            cfg["sim_measures"])
    n = w["local_batch"]
    bound = steps * sum(roofline.pair_maps_bound_s(k, n, *dims)[0]
                        for k in roofline.PAIR_MAPS)
    bound += evals * roofline.pair_maps_bound_s(
        "pair_maps_fwd", w["dev_rows"], *dims)[0]
    return 100.0 * bound / seconds
