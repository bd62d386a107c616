"""The yardstick's counts against hand counts, the stored model FLOPs
against a fresh count over the reference, and the trace reduction on
made-up events."""

import json

import pytest

from portbench import harness as H
from portbench.costs import PEAK_BYTES, PEAK_FLOPS
from portbench.costs import kernels as K
from portbench.costs import model_flops


def test_k1_counts_by_hand():
    # 2 * B*H*W * 9F * 4F * (T - 1)
    assert K.k1_flops(16, 24, 24, 24, 128) == pytest.approx(250.0e9,
                                                            rel=1e-3)
    assert K.k1_flops(16, 6, 8, 8, 128) == pytest.approx(6.04e9, rel=1e-3)
    # zx + the recurrent kernel + h, bf16: 284.3 MB at the downscale shape
    assert K.k1_bytes(16, 24, 24, 24, 128, "bfloat16") == pytest.approx(
        284.3e6, rel=1e-3)
    bound = K.k1_bound_s(16, 24, 24, 24, 128, "bfloat16")
    assert bound == pytest.approx(250.04e9 / 989e12, rel=1e-3)
    assert K.k1_bound_s(16, 6, 8, 8, 128, "float32") == pytest.approx(
        6.04e9 / PEAK_FLOPS["tf32"], rel=1e-3)


def test_k2_counts_by_hand():
    # 96 field pairs of 96 x 96, 9 x 9 windows, 100 thresholds
    assert K.k2_ops(2, 24, 96, 96, 2, 9, 100) == pytest.approx(0.725e9,
                                                               rel=2e-3)
    assert K.k2_bytes(2, 24, 96, 96, 2, 9) == pytest.approx(10.1e6,
                                                            rel=5e-3)
    assert K.k2_bound_s(2, 24, 96, 96, 2, 9, 100) == pytest.approx(
        max(0.725e9 / 67e12, 10.1e6 / PEAK_BYTES), rel=5e-3)


@pytest.mark.parametrize("name", ["flagship", "train_main"])
def test_stored_model_flops_are_the_reference_count(name):
    cfg = json.loads((H.BENCH / "configs" / f"{name}.json").read_text())
    assert cfg["model_flops"] == model_flops.count(cfg)


def _trace():
    # Two K1 ranges; kernels launched inside and outside them; a gap.
    host = [("portbench.traced", 0, 1000), ("portbench.k1", 100, 200),
            ("aten::conv2d", 300, 400), ("portbench.k1", 600, 700)]
    launches = {1: 110, 2: 150, 3: 310, 4: 650}
    device = [("convlstm_step", 120, 180, 1), ("pack", 180, 190, 2),
              ("conv", 320, 500, 3), ("convlstm_step", 660, 690, 4),
              ("Memcpy HtoD", 900, 950, 99)]
    return H.TraceData(device, host, launches, 0, 1000, 1e-6, 2)


def test_trace_reduction():
    tr = _trace()
    assert H.busy_s(tr) == pytest.approx(330e-9)
    assert H.kernels_in(tr, "portbench.k1") == (pytest.approx(100e-9), 3)
    ops = dict(H.device_ops(tr))
    assert ops["convlstm_step"] == pytest.approx(90e-9)
    gaps = dict(H.idle_gaps(tr))
    # Idle 0-120, 190-320, 500-660, 690-900 and 950-1000; at each middle
    # no range but the window is open.
    assert sum(gaps.values()) == pytest.approx(670e-9)
    assert [k for k in gaps] == ["host"]
    assert [d[0] for d in tr.device if H.is_kernel(d[0])] == [
        "convlstm_step", "pack", "conv", "convlstm_step"]


def test_idle_gaps_name_the_innermost_open_range():
    host = [("portbench.traced", 0, 1000), ("portbench.host_gate", 0, 800),
            ("aten::fft", 50, 150)]
    device = [("k", 800, 1000, 1)]
    tr = H.TraceData(device, host, {}, 0, 1000, 1e-6, 1)
    assert dict(H.idle_gaps(tr)) == {"portbench.host_gate":
                                     pytest.approx(800e-9)}
