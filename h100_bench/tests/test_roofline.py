"""Hand-worked counts of the roofline arithmetic."""

import json
import os

import pytest

from h100_bench import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_maxsim_int8_1m_at_v4():
    # 2 x 256 q x (4 x 40) rows x 1,048,576 x 40 tokens x 50 lanes
    ops = roofline.maxsim_ops(256, 1 << 20, 50, 40, 40, 4)
    assert ops == 2 * 256 * 160 * (1 << 20) * 40 * 50
    assert ops == pytest.approx(1.718e14, rel=1e-3)
    bound, by = roofline.maxsim_bound_s(256, 1 << 20, 50, 40, 40, 4, "int8")
    assert by == "operations"
    assert bound * 1e3 == pytest.approx(86.8, abs=0.05)


def test_maxsim_bf16_262k_at_v4_wide():
    bound, by = roofline.maxsim_bound_s(256, 262144, 300, 40, 40, 4, "bf16")
    assert by == "operations"
    assert bound * 1e3 == pytest.approx(260.6, abs=0.05)


def test_maxsim_bytes_follow_the_packed_layouts():
    # int8 at V4: Dp 64 lanes, W2P 40; queries 160 rows of 64 codes + a
    # float32 scale each; a bf16 aux pair a candidate; float32 scores
    c, nq = 1000, 2
    want = nq * 160 * 64 + 4 * nq * 160 + c * 40 * 64 + 4 * c + 4 * nq * c
    assert roofline.maxsim_bytes(nq, c, 50, 40, 40, 4, "int8") == want
    # bf16 at V4_WIDE: Dp = round_up(301, 16) = 304 lanes of 2 bytes
    want = 2 * (nq * 160 * 304 + c * 40 * 304) + 4 * nq * c
    assert roofline.maxsim_bytes(nq, c, 300, 40, 40, 4, "bf16") == want
    # int4 holds half the int8 pool's bytes
    assert (roofline.maxsim_bytes(nq, c, 50, 40, 40, 4, "int8")
            - roofline.maxsim_bytes(nq, c, 50, 40, 40, 4, "int4")) \
        == c * 40 * 64 // 2


def test_pair_maps_at_batch_50_v4():
    # 2 N M W1 D (D + W2) = 2 x 50 x 4 x 40 x 50 x 90
    assert roofline.pair_maps_ops("pair_maps_fwd", 50, 50, 40, 40, 4) \
        == 72_000_000
    assert roofline.pair_maps_ops("pair_maps_bwd_qa", 50, 50, 40, 40, 4) \
        == 144_000_000
    # the forward reads q, a, W and writes the map: bytes bound it
    bound, by = roofline.pair_maps_bound_s("pair_maps_fwd", 50, 50, 40, 40, 4)
    floats = 50 * 40 * 50 * 2 + 4 * 50 * 50 + 50 * 40 * 40 * 4
    assert by == "bytes"
    assert bound == pytest.approx(4 * floats / 3.35e12)
    assert bound * 1e3 == pytest.approx(0.0006, abs=5e-5)


def test_v4_sample_flops():
    cfg = config("v4")
    assert roofline.features(cfg) == 1 * 1 * 64 + 2
    conv = [(h, w, c, oh, ow, oc) for h, w, c, oh, ow, oc
            in roofline.conv_stack(cfg)]
    assert conv == [(40, 40, 4, 36, 36, 32), (9, 9, 32, 5, 5, 64)]
    fwd = (2 * 4 * 40 * 50 * 90            # pair maps
           + 2 * 36 * 36 * 32 * 5 * 5 * 4  # conv0
           + 2 * 5 * 5 * 64 * 5 * 5 * 32   # conv1
           + 2 * 66 * 32 + 2 * 32 * 2)     # fc1, fc2
    assert roofline.forward_flops(cfg) == fwd
    assert roofline.train_flops(cfg) == pytest.approx(3 * fwd)
    assert 36e6 < roofline.train_flops(cfg) < 38e6


def test_v4_wide_features():
    cfg = config("v4_wide")
    assert roofline.features(cfg) == 128 + 2
    assert roofline.conv_stack(cfg)[1] == (9, 9, 64, 5, 5, 128)


def test_peaks():
    assert roofline.PEAK_OPS_PER_S["3xtf32"] == pytest.approx(165e12)
    assert roofline.MAXSIM_PEAK == {"bf16": "bf16", "int8": "int8",
                                    "int4": "int8"}
