"""Numpy golden oracles for the metric suite.

Mirrors the reference's offline numpy/xarray metric twins
(gan/metrics.py:48-60,113-118,143-152,193-198) plus brute-force versions of
the jitted metrics, for use in tests.
"""

from __future__ import annotations

import numpy as np

EPSILON = 1e-7


def wind_speed_weighted_rmse_np(real, fake, eps=4.0, t=0.425):
    u, v = real[..., 0], real[..., 1]
    u_hat, v_hat = fake[..., 0], fake[..., 1]
    est = np.sqrt(u_hat**2 + v_hat**2)
    rea = np.sqrt(u**2 + v**2)
    beta = (eps + rea) / (eps + est)
    tau = np.where(est >= rea, t, 1 - t)
    result = tau * ((u_hat - beta * u) ** 2 + (v_hat - beta * v) ** 2)
    result = np.where(np.isnan(result), 0.0, result)
    return np.sqrt(np.mean(result, axis=(1, 2, 3)))


def tanh_wind_speed_weighted_rmse_np(real_uv, fake_uv, eps=4.0, t=0.425):
    """Reference tanh_wind_speed_weighted_rmse_from_xarray
    (gan/metrics.py:48-60) on (u, v) array pairs."""
    u, v = real_uv
    u_hat, v_hat = fake_uv
    est = np.sqrt(u_hat**2 + v_hat**2)
    rea = np.sqrt(u**2 + v**2)
    beta = (eps + rea) / (eps + est)
    tau = np.where(est >= rea, t, 1 - t)
    wsw = tau * ((u_hat - beta * u) ** 2 + (v_hat - beta * v) ** 2)
    m = (np.mean(wsw) + np.quantile(wsw, 0.5)) / 2
    return np.tanh(wsw / m)


def extreme_weighted_rmse_np(real, fake):
    sq = real**2
    weights = np.divide(sq, np.sum(sq), out=np.zeros_like(sq),
                        where=np.sum(sq) != 0)
    result = weights * (real - fake) ** 2
    result = np.where(np.isnan(result), 0.0, result)
    return np.sqrt(np.sum(result, axis=(1, 2, 3, 4)))


def wind_speed_rmse_np(real, fake):
    u, v = real[..., 0], real[..., 1]
    u_hat, v_hat = fake[..., 0], fake[..., 1]
    est = np.sqrt(u_hat**2 + v_hat**2)
    rea = np.sqrt(u**2 + v**2)
    result = np.where(np.isnan((rea - est) ** 2), 0.0, (rea - est) ** 2)
    return np.sqrt(np.mean(result, axis=(1, 2, 3)))


def _cos_sim_np(a, b, axis=-1):
    an = a / np.maximum(np.sqrt(np.sum(a * a, axis=axis, keepdims=True)),
                        1e-6)
    bn = b / np.maximum(np.sqrt(np.sum(b * b, axis=axis, keepdims=True)),
                        1e-6)
    return np.sum(an * bn, axis=axis)


def angular_cosine_distance_np(real, fake):
    cs = np.clip(_cos_sim_np(real, fake), -1, 1)
    return np.mean(np.arccos(cs) / np.pi, axis=(1, 2, 3))


def cosine_similarity_np(real_uv, fake_uv):
    """Reference cosine_similarity_from_xarray (gan/metrics.py:113-118)."""
    u, v = real_uv
    u_hat, v_hat = fake_uv
    scalar_prod = u * u_hat + v * v_hat
    return scalar_prod / (np.sqrt(u**2 + v**2) * np.sqrt(u_hat**2 + v_hat**2))


def log_spectral_distance_np(real, fake):
    ps_real = np.abs(np.fft.rfft2(real, axes=(2, 3))) ** 2
    ps_fake = np.abs(np.fft.rfft2(fake, axes=(2, 3))) ** 2
    ratio = (ps_real + EPSILON) / (ps_fake + EPSILON)
    result = (10 * np.log10(ratio)) ** 2
    lsd = np.sqrt(np.mean(result, axis=(1, 2, 3, 4)))
    return np.where(np.isnan(lsd), 0.0, lsd)


def log_spectral_distance_fullfft_np(real, fake):
    """Reference log_spectral_distance_from_xarray (gan/metrics.py:143-152)
    which uses the full fft2 and means over the leading axis."""
    ps_real = np.abs(np.fft.fft2(real)) ** 2
    ps_fake = np.abs(np.fft.fft2(fake)) ** 2
    ratio = (ps_real + EPSILON) / (ps_fake + EPSILON)
    result = (10 * np.log10(ratio)) ** 2
    return np.mean(result, axis=0)


def rmse_np(real, fake):
    """Reference rmse_from_xarray (gan/metrics.py:193-198)."""
    u, v = real[..., 0], real[..., 1]
    u_hat, v_hat = fake[..., 0], fake[..., 1]
    result = (u - u_hat) ** 2 + (v - v_hat) ** 2
    return np.sqrt(np.mean(result, axis=(1, 2, 3)))


def spatial_ks_bruteforce_np(real, fake, patch_size=None, num_points=100,
                             lo=-30.0, hi=30.0):
    """Direct patch-extraction KS (the reference algorithm,
    gan/metrics.py:155-187), O(HW * patch^2) — test oracle only."""
    b, t, h, w, c = real.shape
    # Default from the HEIGHT axis (shape[2]), exactly like the library
    # and the reference (gan/metrics.py:166) — a w//10 default here would
    # silently compare different statistics on non-square fields.
    patch_size = patch_size or h // 10
    points = np.linspace(lo, hi, num_points)
    oh, ow = h - patch_size + 1, w - patch_size + 1
    acc = np.zeros((oh, ow))
    n = 0
    for ti in range(t):
        for ch in range(c):
            for bi in range(b):
                r = real[bi, ti, :, :, ch]
                f = fake[bi, ti, :, :, ch]
                for i in range(oh):
                    for j in range(ow):
                        pr = r[i:i + patch_size, j:j + patch_size].ravel()
                        pf = f[i:i + patch_size, j:j + patch_size].ravel()
                        cdf_r = (pr[None, :] <= points[:, None]).mean(axis=1)
                        cdf_f = (pf[None, :] <= points[:, None]).mean(axis=1)
                        acc[i, j] += np.max(np.abs(cdf_r - cdf_f))
                        if ti == 0 and ch == 0 and bi == 0:
                            n += 1
    return acc / (b * t * c)
