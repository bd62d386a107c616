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
from windtpu_torch.metrics.metrics import spatially_convolved_ks_stat
from windtpu_torch.ops.ks import spatial_ks

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


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    cases = [((2, 3, 96, 96, 2), dict(patch_size=9, num_points=100)),
             ((1, 3, 37, 53, 2), dict(patch_size=5, num_points=25)),
             ((1, 1, 12, 9, 1), dict(patch_size=9, num_points=1)),
             ((1, 2, 16, 16, 1), dict(patch_size=1, num_points=7))]
    for i, (shape, kw) in enumerate(cases):
        real, fake = (torch.from_numpy(a).cuda()
                      for a in pair(shape, 8.0, seed=30 + i))
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
