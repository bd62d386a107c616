"""Domain metric suite on ``(B, T, H, W, C)`` tensors (counterpart of
``windtpu/metrics/metrics.py``).

Conventions kept from the JAX package:

* per-sample reductions return shape ``(B,)``;
* NaNs in intermediate results are zeroed at the same places;
* the Dujardin wind-speed weighting constants eps=4, t=0.425.

The spatial KS statistic is the max over a grid of thresholds of
``|CDF_real - CDF_fake|`` in every sliding patch, where a patch's empirical
CDF at threshold p is the box mean of the indicator image ``x <= p``.
:func:`spatially_convolved_ks_stat` computes it with integral images (two
cumsums per threshold); it is the plain version of the CUDA kernel in
:mod:`windtpu_torch.ops.ks`, which :func:`spatial_ks_scalar` launches for
tensors on the card.

:mod:`windtpu_torch.metrics.oracles` holds the numpy twins the tests use.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

EPSILON = 1e-7  # tf.keras.backend.epsilon()

# Dujardin & Lehning (2020) constants.
DUJARDIN_EPS = 4.0
DUJARDIN_T = 0.425


def _zero_nans(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def encoded_features_l2_distance(a: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """L2 distance in encoder feature space over (B, T, latent)."""
    result = _zero_nans((a - b) ** 2)
    return torch.sqrt(torch.mean(result, dim=(1, 2)))


def wind_speed_weighted_rmse(real: torch.Tensor,
                             fake: torch.Tensor) -> torch.Tensor:
    """Dujardin wind-speed-weighted RMSE, shape (B,)."""
    u, v = real[..., 0], real[..., 1]
    u_hat, v_hat = fake[..., 0], fake[..., 1]
    est = torch.sqrt(u_hat**2 + v_hat**2)
    rea = torch.sqrt(u**2 + v**2)
    beta = (DUJARDIN_EPS + rea) / (DUJARDIN_EPS + est)
    tau = torch.where(est >= rea, DUJARDIN_T, 1.0 - DUJARDIN_T)
    result = tau * ((u_hat - beta * u) ** 2 + (v_hat - beta * v) ** 2)
    result = _zero_nans(result)
    return torch.sqrt(torch.mean(result, dim=(1, 2, 3)))


def extreme_weighted_rmse(real: torch.Tensor,
                          fake: torch.Tensor) -> torch.Tensor:
    """RMSE weighted by wind extremeness, shape (B,).  The weights are
    normalized by the sum over the WHOLE batch."""
    sq = real**2
    denom = torch.sum(sq)
    weights = torch.where(denom == 0, torch.zeros_like(sq), sq / denom)
    result = _zero_nans(weights * (real - fake) ** 2)
    return torch.sqrt(torch.sum(result, dim=(1, 2, 3, 4)))


def wind_speed_rmse(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Plain wind-speed RMSE, shape (B,)."""
    u, v = real[..., 0], real[..., 1]
    u_hat, v_hat = fake[..., 0], fake[..., 1]
    est = torch.sqrt(u_hat**2 + v_hat**2)
    rea = torch.sqrt(u**2 + v**2)
    result = _zero_nans((rea - est) ** 2)
    return torch.sqrt(torch.mean(result, dim=(1, 2, 3)))


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                       dim: int = -1) -> torch.Tensor:
    """Keras-convention cosine similarity (the true cos, not the loss)."""
    a_n = a * torch.rsqrt(torch.clamp(
        torch.sum(a * a, dim=dim, keepdim=True), min=1e-12))
    b_n = b * torch.rsqrt(torch.clamp(
        torch.sum(b * b, dim=dim, keepdim=True), min=1e-12))
    return torch.sum(a_n * b_n, dim=dim)


def angular_cosine_distance(real: torch.Tensor,
                            fake: torch.Tensor) -> torch.Tensor:
    """acos(cos_sim)/pi averaged over (T, H, W), shape (B,)."""
    cos_sim = torch.clamp(_cosine_similarity(real, fake), -1.0, 1.0)
    return torch.mean(torch.arccos(cos_sim) / math.pi, dim=(1, 2, 3))


def opposite_cosine_similarity(real: torch.Tensor,
                               fake: torch.Tensor) -> torch.Tensor:
    """0.5 * (1 - cos_sim), shape (B,)."""
    cos_sim = _cosine_similarity(real, fake)
    return torch.mean(0.5 * (1.0 - cos_sim), dim=(1, 2, 3))


def log_spectral_distance(real: torch.Tensor,
                          fake: torch.Tensor) -> torch.Tensor:
    """LSD between 2-D power spectra (rfft2 over H, W per channel),
    shape (B,)."""
    def power(x):
        return torch.abs(torch.fft.rfft2(x, dim=(2, 3))) ** 2

    num = power(real) + EPSILON
    den = power(fake) + EPSILON
    ratio = torch.where(den == 0, torch.zeros_like(num), num / den)
    log10 = torch.where(ratio > 0, torch.log(ratio) / math.log(10.0),
                        torch.zeros_like(ratio))
    result = (10.0 * log10) ** 2
    return _zero_nans(torch.sqrt(torch.mean(result, dim=(1, 2, 3, 4))))


def _box_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over all (size x size) windows (VALID), x: (..., H, W), by an
    integral image: two cumsums and four shifted views."""
    s = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    s = torch.nn.functional.pad(s, (1, 0, 1, 0))
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = h - size + 1, w - size + 1
    a = s[..., size:size + oh, size:size + ow]
    b = s[..., size:size + oh, 0:ow]
    c = s[..., 0:oh, size:size + ow]
    d = s[..., 0:oh, 0:ow]
    return (a - b - c + d) / float(size * size)


def ks_fields(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> f32 (B*T*C, H, W): each (time, channel) slice is
    an independent field."""
    x = torch.movedim(x, -1, 2)
    return x.reshape((-1,) + tuple(x.shape[-2:])).float()


def ks_thresholds(num_points: int, lo: float, hi: float,
                  device) -> torch.Tensor:
    """The threshold grid, made by one call for the kernel and its plain
    version so that both compare against the same f32 values."""
    return torch.linspace(lo, hi, num_points, dtype=torch.float32,
                          device=device)


def spatially_convolved_ks_stat(
    real: torch.Tensor,
    fake: torch.Tensor,
    patch_size: Optional[int] = None,
    num_points: int = 100,
    lo: float = -30.0,
    hi: float = 30.0,
) -> torch.Tensor:
    """Mean spatial Kolmogorov-Smirnov image, shape (OH, OW): for every
    sliding (patch_size x patch_size) window, ``max_p |CDF_real(p) -
    CDF_fake(p)|`` over the threshold grid, averaged over batch, time and
    channels.  ``patch_size`` defaults to ``fake.shape[2] // 10``."""
    patch_size = patch_size or fake.shape[2] // 10
    fr, ff = ks_fields(real), ks_fields(fake)
    oh = fr.shape[-2] - patch_size + 1
    ow = fr.shape[-1] - patch_size + 1
    ks = torch.zeros((fr.shape[0], oh, ow), dtype=torch.float32,
                     device=fr.device)
    for p in ks_thresholds(num_points, lo, hi, fr.device):
        cdf_r = _box_mean((fr <= p).float(), patch_size)
        cdf_f = _box_mean((ff <= p).float(), patch_size)
        ks = torch.maximum(ks, torch.abs(cdf_r - cdf_f))
    return torch.mean(ks, dim=0)


def spatial_ks_scalar(real: torch.Tensor, fake: torch.Tensor,
                      **kw) -> torch.Tensor:
    """Scalar summary of the KS image (its mean), for in-step logging.
    Tensors on the card go through the CUDA kernel, CPU tensors through
    the plain version (:func:`windtpu_torch.ops.ks.spatial_ks`)."""
    from windtpu_torch.ops.ks import spatial_ks

    return torch.mean(spatial_ks(real, fake, **kw))


ALL_GENERATOR_METRICS = {
    "acd": angular_cosine_distance,
    "lsd": log_spectral_distance,
    "extreme_rmse": extreme_weighted_rmse,
    "ws_weighted_rmse": wind_speed_weighted_rmse,
    "ws_rmse": wind_speed_rmse,
}
