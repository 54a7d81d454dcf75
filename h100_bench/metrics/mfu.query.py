"""The whole call's share of the card's peak: what the window's calls
needed (``roofline.query_call_ops``: the scoring, 2 Nq M W1 C W2 D, and
the queries' projection) over the window's wall time at the peak of the
pool's operand type (bf16 989 TFLOP/s, int8 and int4 1,979 TOP/s)."""

from h100_bench import roofline


def read(run):
    w, cfg = run.work, run.config
    if not w.get("calls"):
        return None
    ops = w["calls"] * roofline.query_call_ops(
        w["batch"], w["pool"], cfg["embed_dim"], cfg["question_len"],
        cfg["answer_len"], cfg["sim_measures"])
    peak = roofline.PEAK_OPS_PER_S[roofline.MAXSIM_PEAK[w["pool_dtype"]]]
    return 100.0 * ops / (w["window_s"] * peak)
