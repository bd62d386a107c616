"""Terrain descriptor stencils as convolutions on the device.

Counterpart of ``windtpu/ops/stencil.py``.  Every descriptor is a fixed,
NaN-aware convolution stencil (a weighted sum over valid cells divided by
the number of valid cells).  JAX runs these with
``lax.conv_general_dilated`` outside any Pallas kernel, so the port runs
them with ``F.conv2d`` on ``(N, 1, H, W)`` tensors: cross-correlation,
SAME padding and odd kernel sizes, as in JAX.

**Full f32 on the card.**  cuDNN runs an f32 convolution in TF32 (a 10-bit
mantissa) wherever ``torch.backends.cudnn.allow_tf32`` is set, which is
PyTorch's default.  The stencils average elevations of up to about
4,800 m, where TF32 errs by metres, and the TPI is the DEM minus such a
mean.  So this module switches TF32 off around its own convolutions
(:func:`_full_f32`) and does not rely on the caller's settings.

Definitions (as in the JAX module):

* ``tpi(dem, scale_px)`` = dem - disc_mean(dem, diameter=scale_px);
* ``gradient_descriptors``: the DEM smoothed by a disc mean of the gradient
  scale, then central differences per metre with replicated edges ->
  ``we_derivative``, ``sn_derivative``, ``slope = arctan(|grad z|)``,
  ``aspect = arctan2(sn, we)``;
* ``ridge_index``: ``dem - mean along a line`` at four orientations as one
  4-output-channel convolution; its largest positive response and the
  crest axis perpendicular to the line that gave it (ties go to the first
  orientation, as ``jnp.argmax``'s and ``torch.argmax``'s do).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from windtpu_torch.core.device import resolve_device


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions in full f32 inside the block; the caller's
    setting is restored after it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _disc_kernel(diameter_px: float) -> np.ndarray:
    """Binary disc of the given diameter (pixels), normalized later."""
    r = max(float(diameter_px) / 2.0, 1.0)
    n = int(np.ceil(r)) * 2 + 1
    yy, xx = np.mgrid[:n, :n] - n // 2
    return ((xx**2 + yy**2) <= r**2).astype(np.float32)


def _line_kernel(length_px: int, theta: float) -> np.ndarray:
    """Binary line segment of the given length through the kernel centre,
    oriented at angle ``theta`` (radians, mathematical convention)."""
    r = max(int(length_px) // 2, 1)
    n = 2 * r + 1
    k = np.zeros((n, n), np.float32)
    c, s = np.cos(theta), np.sin(theta)
    for t in np.linspace(-r, r, 4 * n):
        y, x = int(round(r + t * s)), int(round(r + t * c))
        k[y, x] = 1.0
    return k


def _conv_same(x: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """(N, H, W) planes x (K, kh, kw) odd kernels -> (N, K, H, W), SAME
    cross-correlation in full f32."""
    w = torch.as_tensor(kernels, dtype=torch.float32, device=x.device)
    kh, kw = w.shape[-2:]
    with _full_f32():
        return F.conv2d(x[:, None], w[:, None], padding=(kh // 2, kw // 2))


def _masked_mean(dem: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """NaN-aware stencil mean of ``dem`` (H, W) under each kernel ->
    (K, H, W): one convolution of the stacked (filled, valid) planes."""
    valid = ~torch.isnan(dem)
    filled = torch.where(valid, dem, 0.0)
    s, n = _conv_same(torch.stack([filled, valid.float()]), kernels)
    return s / torch.clamp(n, min=1.0)


def disc_mean(dem: torch.Tensor, diameter_px: int) -> torch.Tensor:
    """NaN-aware mean over a disc neighbourhood (edge-normalized)."""
    return _masked_mean(dem, _disc_kernel(diameter_px)[None])[0]


def tpi(dem: torch.Tensor, scale_px: int) -> torch.Tensor:
    """Topographic position index at the given pixel scale."""
    return dem - disc_mean(dem, scale_px)


def gradient_descriptors(dem: torch.Tensor, scale_px: int,
                         res_meters: Tuple[float, float]):
    """(we_derivative, sn_derivative, slope, aspect) at the given scale.

    ``res_meters`` = (metres per pixel along y/lat, along x/lon); a
    north-up raster passes a negative y resolution, which flips the sign
    of the sn derivative accordingly."""
    smoothed = disc_mean(dem, max(int(scale_px), 1))
    res_y, res_x = res_meters
    padded = F.pad(smoothed[None, None], (1, 1, 1, 1),
                   mode="replicate")[0, 0]
    ddx = (padded[1:-1, 2:] - padded[1:-1, :-2]) / (2.0 * res_x)
    ddy = (padded[2:, 1:-1] - padded[:-2, 1:-1]) / (2.0 * res_y)
    slope = torch.arctan(torch.sqrt(ddx**2 + ddy**2))
    aspect = torch.atan2(ddy, ddx)
    return ddx, ddy, slope, aspect


def ridge_index(dem: torch.Tensor, scale_px: int):
    """(ridge_index_norm, ridge_index_dir): directional-TPI ridge detector
    (definition in ``windtpu/ops/stencil.py:ridge_index``).  The four line
    orientations (0, 45, 90, 135 degrees) run as one 4-output-channel
    convolution."""
    thetas = np.arange(4) * (np.pi / 4.0)
    kernels = np.stack([_line_kernel(scale_px, t) for t in thetas])
    means = _masked_mean(dem, kernels)                      # (4, H, W)
    filled = torch.where(torch.isnan(dem), 0.0, dem)
    resp = torch.clamp(filled[None] - means, min=0.0)
    norm = torch.amax(resp, dim=0)
    crest = torch.as_tensor((thetas + np.pi / 2.0) % np.pi,
                            dtype=torch.float32, device=dem.device)
    return norm, crest[torch.argmax(resp, dim=0)]


def meters_per_pixel(lat: np.ndarray, lon: np.ndarray) -> Tuple[float, float]:
    """Approximate (res_y, res_x) in metres for a lat/lon grid, negative
    when the coordinate decreases with index (north-up rasters)."""
    r_earth = 6371000.0
    deg = np.pi / 180.0
    dlat = float(lat[1] - lat[0]) if len(lat) > 1 else 1.0
    dlon = float(lon[1] - lon[0]) if len(lon) > 1 else 1.0
    mean_lat = float(np.mean(lat))
    res_y = dlat * deg * r_earth
    res_x = dlon * deg * r_earth * np.cos(mean_lat * deg)
    return res_y, res_x


def fill_nans(dem: torch.Tensor, iterations: int = 50) -> torch.Tensor:
    """Iterative neighbour-mean NaN infill: ``iterations`` passes of a 3x3
    mean over the valid neighbours, each filling only the NaN cells that
    have one; what is still NaN after them takes the DEM's mean.  The
    passes stop once no NaN is left, after which each would return its
    input unchanged."""
    ones = np.ones((1, 3, 3), np.float32)
    d = dem
    for _ in range(iterations):
        isnan = torch.isnan(d)
        if not bool(isnan.any()):
            break
        s, n = _conv_same(torch.stack([torch.where(isnan, 0.0, d),
                                       (~isnan).float()]), ones)[:, 0]
        d = torch.where(isnan & (n > 0), s / torch.clamp(n, min=1.0), d)
    return torch.where(torch.isnan(d), torch.nanmean(dem), d)


def topographic_descriptors(dem, lat: np.ndarray, lon: np.ndarray,
                            scale_meters: float = 500.0,
                            device=None) -> Dict[str, torch.Tensor]:
    """The full descriptor set of the JAX package's topo job: elevation,
    ``tpi_<scale>``, we/sn derivatives, slope, aspect and the ridge index
    pair, as f32 tensors on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    res_y, res_x = meters_per_pixel(lat, lon)
    scale_px = max(int(round(scale_meters / abs(res_x))), 1)
    dem = fill_nans(torch.as_tensor(dem, dtype=torch.float32,
                                    device=device))
    t = tpi(dem, scale_px)
    grad_scale = max(int(round(scale_px / 4)), 1)
    ddx, ddy, slope, aspect = gradient_descriptors(
        dem, grad_scale, (res_y, res_x))
    ridge_norm, ridge_dir = ridge_index(dem, scale_px)
    return {
        "elevation": dem,
        f"tpi_{int(scale_meters)}": t,
        "we_derivative": ddx,
        "sn_derivative": ddy,
        "slope": slope,
        "aspect": aspect,
        "ridge_index_norm": ridge_norm,
        "ridge_index_dir": ridge_dir,
    }
