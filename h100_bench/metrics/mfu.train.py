"""The whole step's share of the card's peak over the traced window:
this card's trained samples times a sample's forward and backward
(``roofline.train_flops``: pair maps, convs, fc), plus the dev evals'
forwards, over the window at the 3xTF32 rate of 165 TFLOP/s
(``roofline.PEAK_OPS_PER_S['3xtf32']``), the rate the repo's bounds take
for float32-accurate products."""

from h100_bench import roofline


def read(run):
    tr, w, cfg = run.device_trace, run.work, run.config
    if tr is None or not w.get("traced_steps") or tr.window_s <= 0:
        return None
    flops = w["traced_steps"] * w["local_batch"] * roofline.train_flops(cfg)
    flops += w["traced_evals"] * w["dev_rows"] * roofline.forward_flops(cfg)
    peak = roofline.PEAK_OPS_PER_S[roofline.PAIR_MAPS_PEAK]
    return 100.0 * flops / (tr.window_s * peak)
