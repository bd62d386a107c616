"""Operations and bytes of the port's hand-written kernels, counted from
the shapes of a call: each input byte read once, each output byte written
once, whatever the kernel reads again.

K1, the ConvLSTM sequence (zx (B, T, H, W, 4F), recurrent kernel (3, 3, F,
4F) -> h (B, T, H, W, F)): T - 1 recurrent 3x3 products of F -> 4F
channels at every pixel, 2 operations per multiply-add (h_{-1} = 0, so
step 0 has none).

K2, the spatial KS statistic over N = B*T*C field pairs of H x W with
P x P windows and Q thresholds, in its running-sum form: per pair and
threshold 2HW comparisons, HW differences, 2*OH*W vertical and 2*OH*OW
horizontal adds and 2*OH*OW for the absolute value and the max.
"""

from __future__ import annotations

from portbench.costs import PEAK_BYTES, PEAK_FLOPS

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def k1_flops(b: int, t: int, h: int, w: int, f: int) -> float:
    return 2.0 * b * h * w * 9 * f * 4 * f * (t - 1)


def k1_bytes(b: int, t: int, h: int, w: int, f: int, dtype: str) -> float:
    n = ITEMSIZE[dtype]
    return float(n) * (b * t * h * w * 4 * f + 9 * f * 4 * f
                       + b * t * h * w * f)


def k1_peak(dtype: str) -> float:
    """bf16 on the tensor cores; f32 against the dense TF32 rate, the
    fastest route the card has for f32 operands."""
    return PEAK_FLOPS["bfloat16" if dtype == "bfloat16" else "tf32"]


def k1_bound_s(b, t, h, w, f, dtype: str) -> float:
    """The least time of one call: operations at the peak or bytes at the
    memory bandwidth, whichever is longer."""
    return max(k1_flops(b, t, h, w, f) / k1_peak(dtype),
               k1_bytes(b, t, h, w, f, dtype) / PEAK_BYTES)


def k2_ops(b: int, t: int, h: int, w: int, c: int, patch: int,
           points: int) -> float:
    n, oh, ow = b * t * c, h - patch + 1, w - patch + 1
    return float(n) * points * (3 * h * w + 2 * oh * w + 4 * oh * ow)


def k2_bytes(b: int, t: int, h: int, w: int, c: int, patch: int) -> float:
    n, oh, ow = b * t * c, h - patch + 1, w - patch + 1
    return 4.0 * n * (2 * h * w + oh * ow)


def k2_bound_s(b, t, h, w, c, patch, points) -> float:
    """K2 runs on the CUDA cores: operations at the f32 rate."""
    return max(k2_ops(b, t, h, w, c, patch, points) / PEAK_FLOPS["float32"],
               k2_bytes(b, t, h, w, c, patch) / PEAK_BYTES)
