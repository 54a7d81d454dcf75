"""The whole step's share of the card's peak over the traced window: the
traced iterations x the batch x one image's training FLOPs (3 x 2 x the
forward's multiply-adds of the net's TRAIN phase, counted from the
prototxt's shapes by ``convnet_flops``), over the window at the 3xTF32
rate of 165 TFLOP/s (``roofline.PEAK_OPS_PER_S['3xtf32']``), the rate the
repo's bounds take for float32-accurate products."""

from h100_bench import convnet_flops, roofline


def read(run):
    tr, w = run.device_trace, run.work
    if tr is None or not w.get("traced_iters") or tr.window_s <= 0:
        return None
    text = (run.root / run.config["net"]).read_text()
    flops = w["traced_iters"] * w["batch"] * convnet_flops.train_flops(text)
    peak = roofline.PEAK_OPS_PER_S["3xtf32"]
    return 100.0 * flops / (tr.window_s * peak)
