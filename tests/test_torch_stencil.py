"""The port's terrain stencils (windtpu_torch/ops/stencil.py) against
windtpu's on the same DEM: 64 x 80 px of smooth relief with a 600 m edge
and a NaN hole, f32 on both sides.

Elevation, disc means and the TPI are held within 1e-4 relative to the
DEM's largest |value|: one f32 step at 2,000 to 4,000 m is 2.4e-4 m, and
XLA and ATen sum the stencils in different orders.  Derivatives, slope and
angles are held at 1e-4 absolute; the ridge direction exactly wherever its
two largest directional responses differ by more than 1e-3 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.ops import stencil as J
from windtpu_torch.ops import stencil as T

torch.set_num_threads(2)

RES = (-96.0, 75.0)          # metres per pixel, y (north-up) and x
LAT = np.linspace(47.5, 47.0, 64)
LON = np.linspace(7.0, 7.6, 80)


def _dem(holes=True):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :80]
    dem = (1500 + 800 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
           + 30 * rng.standard_normal((64, 80))).astype(np.float32)
    dem[:, 40:] += 600.0                       # an edge
    if holes:
        dem[20:26, 30:37] = np.nan             # a hole
    return dem


def _close(got, want, scale=1.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                               equal_nan=True)


def _near_ties(resp, tol=1e-3):
    """Pixels whose two largest directional responses are within ``tol``."""
    top2 = np.sort(resp, axis=0)[-2:]
    return (top2[1] - top2[0]) <= tol


@pytest.mark.parametrize("scale_px", [8, 2])
def test_disc_mean_and_tpi_match_jax(scale_px):
    dem = _dem()
    scale = float(np.nanmax(np.abs(dem)))
    _close(T.disc_mean(torch.from_numpy(dem), scale_px),
           J.disc_mean(jnp.asarray(dem), scale_px), scale)
    _close(T.tpi(torch.from_numpy(dem), scale_px),
           J.tpi(jnp.asarray(dem), scale_px), scale)


@pytest.mark.parametrize("scale_px", [8, 2])
def test_gradient_descriptors_match_jax(scale_px):
    dem = np.nan_to_num(_dem(), nan=1000.0)
    got = T.gradient_descriptors(torch.from_numpy(dem), scale_px, RES)
    want = J.gradient_descriptors(jnp.asarray(dem), scale_px, RES)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("scale_px", [8, 2])
def test_ridge_index_matches_jax(scale_px):
    dem = T.fill_nans(torch.from_numpy(_dem()))
    norm, direction = T.ridge_index(dem, scale_px)
    jnorm, jdir = J.ridge_index(jnp.asarray(dem.numpy()), scale_px)
    _close(norm, jnorm, float(dem.abs().max()))
    # The responses, to find the near-ties where the direction may flip
    # between two summation orders.
    kernels = np.stack([T._line_kernel(scale_px, t)
                        for t in np.arange(4) * np.pi / 4])
    resp = torch.clamp(dem[None] - T._masked_mean(dem, kernels),
                       min=0.0).numpy()
    clear = ~_near_ties(resp)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(direction.numpy()[clear],
                                  np.asarray(jdir)[clear])
    assert set(np.unique(direction.numpy())) <= set(
        np.float32((np.arange(4) * np.pi / 4 + np.pi / 2) % np.pi))


def test_fill_nans_matches_jax():
    dem = _dem()
    dem[0:3, 70:80] = np.nan                   # a hole on the border
    got = T.fill_nans(torch.from_numpy(dem))
    assert not torch.isnan(got).any()
    _close(got, J.fill_nans(jnp.asarray(dem)), float(np.nanmax(dem)))
    # Fewer passes than the hole is wide: the rest takes the DEM's mean.
    few = T.fill_nans(torch.from_numpy(dem), iterations=1)
    _close(few, J.fill_nans(jnp.asarray(dem), iterations=1),
           float(np.nanmax(dem)))


def test_meters_per_pixel_matches_jax():
    assert T.meters_per_pixel(LAT, LON) == J.meters_per_pixel(LAT, LON)


def test_topographic_descriptors_match_jax():
    dem = _dem()
    got = T.topographic_descriptors(dem, LAT, LON, 500.0, device="cpu")
    want = J.topographic_descriptors(dem, LAT, LON, 500.0)
    assert sorted(got) == sorted(want)
    scale = float(np.nanmax(np.abs(dem)))
    for name in want:
        if name == "ridge_index_dir":
            continue
        _close(got[name], want[name],
               scale if name in ("elevation", "tpi_500",
                                 "ridge_index_norm") else 1.0)
    # 500 m at 75 m per pixel is 7 px.
    kernels = np.stack([T._line_kernel(7, t)
                        for t in np.arange(4) * np.pi / 4])
    elev = got["elevation"]
    resp = torch.clamp(elev[None] - T._masked_mean(elev, kernels),
                       min=0.0).numpy()
    clear = ~_near_ties(resp)
    np.testing.assert_array_equal(got["ridge_index_dir"].numpy()[clear],
                                  np.asarray(want["ridge_index_dir"])[clear])


def test_stencils_keep_the_callers_tf32_setting():
    saved = torch.backends.cudnn.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cudnn.allow_tf32 = setting
            T.tpi(torch.from_numpy(_dem()), 8)
            assert torch.backends.cudnn.allow_tf32 is setting
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.gpu
def test_stencils_on_the_card_match_the_cpu_under_tf32_defaults():
    """On the card, with cuDNN's TF32 switched on as PyTorch's default has
    it, the descriptors stay within 1e-3 m (elevation, TPI) and 1e-5 (the
    derivatives) of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("the stencils run on the card only where there is one")
    dem = _dem() + 2500.0
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = T.topographic_descriptors(dem, LAT, LON, 500.0, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu = T.topographic_descriptors(dem, LAT, LON, 500.0, device="cpu")
    for name, want in cpu.items():
        got = card[name].cpu()
        if name == "ridge_index_dir":
            continue
        tol = 1e-3 if name in ("elevation", "tpi_500",
                               "ridge_index_norm") else 1e-5
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
