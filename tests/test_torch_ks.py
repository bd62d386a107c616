"""The port's spatial-KS statistic (windtpu_torch/ops/ks.py) against the JAX
package's.

On the CPU the wrapper runs its plain version,
windtpu_torch.metrics.metrics.spatially_convolved_ks_stat, which must
reproduce the TPU kernel (windtpu/ops/pallas_ks.py, run in interpret mode as
tests/test_pallas_ks.py runs it), the XLA metric and the brute-force numpy
oracle.  The CUDA kernel itself is held against the plain version by the
gpu-marked test, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.metrics.metrics import (
    spatially_convolved_ks_stat as j_spatially_convolved_ks_stat,
)
from windtpu.ops.pallas_ks import spatial_ks_pallas
from windtpu_torch.metrics import oracles as O
from windtpu_torch.metrics.metrics import (
    _box_mean,
    ks_fields,
    ks_thresholds,
    spatially_convolved_ks_stat,
)
from windtpu_torch.ops.ks import ascending_thresholds, spatial_ks

torch.set_num_threads(2)

# name -> (shape, scale, kwargs)
CASES = {
    "square_12_patch4": ((1, 2, 12, 12, 2), 5.0,
                         dict(patch_size=4, num_points=25)),
    "ragged_9x14_patch3": ((2, 1, 9, 14, 1), 5.0,
                           dict(patch_size=3, num_points=25)),
    "default_patch_from_height": ((1, 1, 20, 31, 2), 8.0,
                                  dict(num_points=20)),
    "one_threshold": ((1, 2, 8, 8, 1), 1.0,
                      dict(patch_size=3, num_points=1, lo=0.0, hi=1.0)),
    "patch_1": ((1, 1, 6, 7, 2), 5.0, dict(patch_size=1, num_points=10)),
    "patch_is_height": ((1, 2, 6, 9, 1), 5.0,
                        dict(patch_size=6, num_points=10)),
}


def pair(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape, dtype=np.float32),
            scale * rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_tpu_kernel_xla_and_oracle(case):
    shape, scale, kw = CASES[case]
    real, fake = pair(shape, scale, seed=sorted(CASES).index(case))
    got = spatial_ks(torch.from_numpy(real), torch.from_numpy(fake),
                     **kw).numpy()
    patch = kw.get("patch_size") or shape[2] // 10
    assert got.shape == (shape[2] - patch + 1, shape[3] - patch + 1)
    assert got.min() >= 0.0 and got.max() <= 1.0
    pallas = np.asarray(spatial_ks_pallas(
        jnp.asarray(real), jnp.asarray(fake), interpret=True, **kw))
    xla = np.asarray(j_spatially_convolved_ks_stat(
        jnp.asarray(real), jnp.asarray(fake), **kw))
    brute = O.spatial_ks_bruteforce_np(real, fake, **kw)
    # Window counts are small integers; the versions differ in where they
    # divide by patch^2 and in the order of the mean over fields.
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, brute, rtol=0, atol=1e-5)


def test_identical_fields_give_exactly_zero():
    x = torch.from_numpy(pair((1, 1, 10, 13, 1), 3.0, seed=20)[0])
    ks = spatial_ks(x, x.clone(), patch_size=3)
    assert ks.shape == (8, 11) and torch.equal(ks, torch.zeros(8, 11))


def test_nan_is_not_below_any_threshold():
    real, fake = pair((1, 1, 8, 8, 1), 2.0, seed=21)
    real[0, 0, 2, 3, 0] = np.nan
    fake[0, 0, 5, 5, 0] = np.nan
    kw = dict(patch_size=3, num_points=15, lo=-5.0, hi=5.0)
    got = spatial_ks(torch.from_numpy(real), torch.from_numpy(fake),
                     **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, O.spatial_ks_bruteforce_np(real, fake, **kw), atol=1e-5)


def test_any_float_type_is_cast_to_f32_fields():
    real, fake = pair((1, 2, 8, 8, 2), 5.0, seed=22)
    r16 = torch.from_numpy(real).to(torch.bfloat16)
    f16 = torch.from_numpy(fake).to(torch.bfloat16)
    got = spatial_ks(r16, f16, patch_size=3, num_points=12)
    want = spatial_ks(r16.float(), f16.float(), patch_size=3, num_points=12)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_cpu_tensors_take_the_plain_version_without_counting():
    real, fake = (torch.from_numpy(a) for a in pair((1, 1, 8, 8, 1), 2.0, 23))
    before = spatial_ks.launches
    got = spatial_ks(real.requires_grad_(), fake, patch_size=2,
                     num_points=5)
    assert spatial_ks.launches == before
    assert not got.requires_grad   # the metric has no gradient
    assert torch.equal(got, spatially_convolved_ks_stat(
        real.detach(), fake, patch_size=2, num_points=5))


@pytest.mark.parametrize("case", ["shapes_differ", "rank", "integer",
                                  "patch_too_large", "no_points"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    real = torch.zeros(1, 2, 8, 8, 2)
    fake = torch.zeros(1, 2, 8, 8, 2)
    kw, err = {}, ValueError
    if case == "shapes_differ":
        fake = torch.zeros(1, 2, 8, 9, 2)
    elif case == "rank":
        real, fake = real[0], fake[0]
    elif case == "integer":
        real, fake, err = real.int(), fake.int(), TypeError
    elif case == "patch_too_large":
        kw = dict(patch_size=9)
    else:
        kw = dict(patch_size=2, num_points=0)
    with pytest.raises(err):
        spatial_ks(real, fake, **kw)


def _threshold_index(x, points):
    """The kernel's per-pixel index: the first k with x <= points[k], and
    len(points) for a NaN."""
    k = torch.searchsorted(points, x.contiguous(), side="left")
    return torch.where(torch.isnan(x), len(points), k)


def threshold_index_form(real, fake, patch_size, num_points, lo=-30.0,
                         hi=30.0):
    """The plain version with each indicator [x <= p_k] replaced by the
    kernel's [k >= k(x)]."""
    fr, ff = ks_fields(real), ks_fields(fake)
    points = ascending_thresholds(num_points, lo, hi, fr.device)
    kr, kf = _threshold_index(fr, points), _threshold_index(ff, points)
    oh, ow = fr.shape[-2] - patch_size + 1, fr.shape[-1] - patch_size + 1
    ks = torch.zeros((fr.shape[0], oh, ow))
    for k in range(num_points):
        cdf_r = _box_mean((k >= kr).float(), patch_size)
        cdf_f = _box_mean((k >= kf).float(), patch_size)
        ks = torch.maximum(ks, torch.abs(cdf_r - cdf_f))
    return torch.mean(ks, dim=0)


def integer_window_form(real, fake, patch_size, num_points, lo=-30.0,
                        hi=30.0):
    """The kernel's arithmetic: integer window sums of d = [k >= k(real)] -
    [k >= k(fake)], the max of |sum| over k, one division by patch^2, then
    the mean over the fields."""
    fr, ff = ks_fields(real), ks_fields(fake)
    points = ascending_thresholds(num_points, lo, hi, fr.device)
    kr, kf = _threshold_index(fr, points), _threshold_index(ff, points)
    best = None
    for k in range(num_points):
        d = (k >= kr).long() - (k >= kf).long()
        sums = d.unfold(1, patch_size, 1).unfold(2, patch_size, 1).sum(
            dim=(-1, -2)).abs()
        best = sums if best is None else torch.maximum(best, sums)
    return torch.mean(best.float() / float(patch_size * patch_size), dim=0)


def _index_form_fields(kind, seed):
    shape, kw = (2, 2, 17, 23, 2), dict(patch_size=4, num_points=30,
                                          lo=-6.0, hi=6.0)
    real, fake = (torch.from_numpy(a) for a in pair(shape, 3.0, seed))
    points = ks_thresholds(kw["num_points"], kw["lo"], kw["hi"], "cpu")
    if kind == "lo_above_hi":
        # Descending thresholds: the same set, so the same statistic.
        kw.update(lo=6.0, hi=-6.0)
    elif kind == "nans":
        real[0, 1, 2:5, 7, 0] = float("nan")
        fake[1, 0, 10, 3:20, 1] = float("nan")
        fake[0, 0, 0, 0, 0] = float("nan")
    elif kind == "ties":
        # Values exactly on the thresholds, and one ulp to either side.
        rng = np.random.default_rng(seed)
        pick = torch.from_numpy(rng.integers(0, len(points), shape))
        on = points[pick]
        side = torch.from_numpy(rng.integers(0, 3, shape))
        on = torch.where(side == 1, torch.nextafter(on, on + 1), on)
        on = torch.where(side == 2, torch.nextafter(on, on - 1), on)
        mask = torch.from_numpy(rng.random(shape) < 0.5)
        real = torch.where(mask, on, real)
        fake = torch.where(~mask, on.flip(0), fake)
    return real, fake, kw


@pytest.mark.parametrize("kind", ["random", "nans", "ties", "lo_above_hi"])
def test_threshold_index_form_equals_plain_exactly(kind):
    real, fake, kw = _index_form_fields(kind, seed=40)
    want = spatially_convolved_ks_stat(real, fake, **kw)
    assert torch.equal(threshold_index_form(real, fake, **kw), want)


@pytest.mark.parametrize("kind", ["random", "nans", "ties", "lo_above_hi"])
def test_integer_window_form_matches_plain(kind):
    real, fake, kw = _index_form_fields(kind, seed=41)
    want = spatially_convolved_ks_stat(real, fake, **kw)
    got = integer_window_form(real, fake, **kw)
    # Exact counts on both sides; the division is placed differently.
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    same = integer_window_form(real, real.clone(), **kw)
    assert torch.equal(same, torch.zeros_like(same))


def _funnel_unit(shift, lanes):
    """__funnelshift_lc(0, unit, shift) for shifts already clamped at 0: the
    unit word (1 in each of ``lanes`` fields) shifted left, 0 from 32 on."""
    unit = np.uint64(0x01010101 if lanes == 4 else 0x00010001)
    shift = np.minimum(shift, 32).astype(np.uint64)
    return ((unit << shift) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _fields(word, lanes):
    """(…,) uint32 -> (…, lanes) field values."""
    bits = 32 // lanes
    return np.stack([(word >> np.uint32(bits * i)) & np.uint32(
        (1 << bits) - 1) for i in range(lanes)], axis=-1).astype(np.int64)


def _abs_diff(a, b, lanes):
    """__vabsdiffu4 / __vabsdiffu2: |a - b| per field, packed."""
    bits = 32 // lanes
    d = np.abs(_fields(a, lanes) - _fields(b, lanes)).astype(np.uint32)
    return sum(d[..., i] << np.uint32(bits * i) for i in range(lanes))


def packed_word_form(real, fake, patch_size, num_points, lo=-30.0, hi=30.0,
                     rows=16):
    """The kernel's word arithmetic in uint32, band by band: e = unit +
    [k >= k(real)] - [k >= k(fake)] for ``lanes`` thresholds per word,
    prefix sums down the band, window sums slid along each row, the max
    over groups of |S - patch^2| per field, one division, the mean.  Any
    carry between fields would show as a wrong count."""
    lanes = 4 if patch_size <= 10 else 2
    fr, ff = ks_fields(real), ks_fields(fake)
    points = ascending_thresholds(num_points, lo, hi, fr.device)
    kr = _threshold_index(fr, points).numpy()
    kf = _threshold_index(ff, points).numpy()
    n, h, w = kr.shape
    p = patch_size
    oh, ow = h - p + 1, w - p + 1
    unit = np.uint32(0x01010101 if lanes == 4 else 0x00010001)
    p2 = np.uint32(p * p) * unit
    best = np.zeros((n, oh, ow), np.uint32)
    for g in range(-(-num_points // lanes)):
        k0b = g * 32
        def below(k):
            return _funnel_unit(np.maximum(k * (32 // lanes) - k0b, 0),
                                lanes)
        e = unit + below(kr) - below(kf)
        for y0 in range(0, oh, rows):
            r_out = min(rows, oh - y0)
            band = e[:, y0:y0 + r_out + p - 1]
            prefix = np.zeros((n, band.shape[1] + 1, w), np.uint32)
            prefix[:, 1:] = np.cumsum(band, axis=1, dtype=np.uint32)
            v = prefix[:, p:p + r_out] - prefix[:, :r_out]
            s = v[:, :, :p].sum(axis=2, dtype=np.uint32)
            for x in range(ow):
                if x:
                    s = s + v[:, :, x + p - 1] - v[:, :, x - 1]
                # The per-field max as the kernel takes it, (a + b + |a -
                # b|) / 2 on whole words.
                a = best[:, y0:y0 + r_out, x]
                d = _abs_diff(s, p2, lanes)
                best[:, y0:y0 + r_out, x] = (a + d + _abs_diff(a, d, lanes)
                                             ) >> np.uint32(1)
    ks = torch.from_numpy(_fields(best, lanes).max(axis=-1)).float()
    ks = ks / float(p * p)
    return torch.mean(ks, dim=0)


@pytest.mark.parametrize("kind", ["random", "nans", "ties", "lo_above_hi"])
@pytest.mark.parametrize("patch_size", [4, 10, 11, 16])
def test_packed_word_form_equals_integer_window_form(kind, patch_size):
    # patch <= 10 counts four thresholds per word, 11 and up two; patch 10
    # is the largest whose byte sums cannot carry.
    real, fake, kw = _index_form_fields(kind, seed=42)
    kw["patch_size"] = patch_size
    got = packed_word_form(real, fake, **kw)
    assert torch.equal(got, integer_window_form(real, fake, **kw))


@pytest.mark.parametrize("num_points,lo,hi", [
    (100, -30.0, 30.0), (25, -30.0, 30.0), (1, 0.0, 1.0), (15, -5.0, 5.0),
    (1000, -1e-3, 1e-3), (7, 2.0, 2.0)])
def test_thresholds_ascend(num_points, lo, hi):
    # The kernel's binary search for k(x) needs non-decreasing points.
    points = ks_thresholds(num_points, lo, hi, "cpu")
    assert bool((points[1:] >= points[:-1]).all())


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    cases = [((2, 3, 96, 96, 2), dict(patch_size=9, num_points=100)),
             ((1, 3, 37, 53, 2), dict(patch_size=5, num_points=25)),
             ((1, 1, 12, 9, 1), dict(patch_size=9, num_points=1)),
             ((1, 2, 16, 16, 1), dict(patch_size=1, num_points=7)),
             ((1, 2, 40, 51, 1), dict(patch_size=16, num_points=30))]
    fields = [tuple(torch.from_numpy(a).cuda()
                    for a in pair(shape, 8.0, seed=30 + i))
              for i, (shape, _) in enumerate(cases)]
    for kind in ("nans", "ties", "lo_above_hi"):
        real, fake, kw = _index_form_fields(kind, seed=34)
        cases.append((real.shape, kw))
        fields.append((real.cuda(), fake.cuda()))
    # The training step's types: real f32, fake bf16, read as they are.
    real, fake = pair((2, 3, 96, 96, 2), 8.0, seed=36)
    cases.append((real.shape, dict(patch_size=9, num_points=100)))
    fields.append((torch.from_numpy(real).cuda(),
                   torch.from_numpy(fake).to("cuda", torch.bfloat16)))
    for i, (shape, kw) in enumerate(cases):
        real, fake = fields[i]
        real[0, 0, 1, 1, 0] = float("nan")
        before = spatial_ks.launches
        got = spatial_ks(real, fake, **kw)
        assert spatial_ks.launches == before + 1
        want = spatially_convolved_ks_stat(real, fake, **kw)
        torch.cuda.synchronize()
        # Exact integer counts on both sides; one division placed
        # differently and the mean over fields in another order.
        assert (got - want).abs().max().item() <= 1e-6, (shape, kw)
        assert torch.equal(spatial_ks(real, real.clone(), **kw),
                           torch.zeros_like(got))
