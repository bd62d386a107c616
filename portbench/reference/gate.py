"""The texture gate, worked out again: an MLP (11 -> 32 -> 32 -> 1, tanh)
predicts each output channel's log high-pass energy from intensive
statistics of the input field; the stitched prediction's high-pass band
(1 - G, G the spectral Gaussian of sigma 7 px) is then scaled per channel
by the gain s that solves E(s) = a + 2 b s + c s^2 = max(target, floor),
clipped to [0.25, 3] (1 where both target and measured energy are under
the floor).  NaN cells are zeroed for the transforms and kept NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIGMA = 7.0


def _gauss_np(ny, nx):
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.fftfreq(nx)[None, :]
    return np.exp(-2.0 * (np.pi * SIGMA) ** 2 * (ky ** 2 + kx ** 2))


def hp_energy_np(x: np.ndarray) -> np.ndarray:
    """Mean over (T, H, W) of the squared high-pass field, by Parseval."""
    ny, nx = x.shape[-2:]
    h2 = (1.0 - _gauss_np(ny, nx)) ** 2
    spec = np.fft.fft2(x.astype(np.float64))
    return (np.sum(h2 * np.abs(spec) ** 2, axis=(-2, -1))
            / float(ny * nx) ** 2).mean(axis=-1)


def features_np(field: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) -> (2, 11)."""
    u, v, e = (field[..., i].astype(np.float64) for i in range(3))

    def chan(x):
        return [np.mean(np.abs(x)), np.std(x), np.log(hp_energy_np(x) + 1e-8)]

    gy = e - np.roll(e, 1, axis=-2)
    gx = e - np.roll(e, 1, axis=-1)
    g2 = gy * gy + gx * gx
    shared = [np.mean(np.sqrt(u * u + v * v)), np.std(e),
              np.log(hp_energy_np(e) + 1e-8), np.mean(np.sqrt(g2)),
              np.log(np.mean(g2) + 1e-10)]
    return np.array([chan(u) + chan(v) + shared, chan(v) + chan(u) + shared])


def predict_log_energy_np(p, field) -> np.ndarray:
    f = (features_np(field) - p["f_mu"]) / p["f_sd"]
    h = np.tanh(f @ p["w1"] + p["b1"])
    h = np.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def apply_gate_targeted(target: torch.Tensor, floor: float,
                        fake: torch.Tensor) -> torch.Tensor:
    """Gate (T, H, W, 2) toward ``target`` (2,)."""
    y = fake.permute(3, 0, 1, 2).double()                 # (2, T, H, W)
    finite = torch.isfinite(y)
    spec = torch.fft.fft2(torch.where(finite, y, torch.zeros_like(y)))
    ny, nx = y.shape[-2:]
    ky = torch.fft.fftfreq(ny, dtype=torch.float64, device=y.device)[:, None]
    kx = torch.fft.fftfreq(nx, dtype=torch.float64, device=y.device)[None, :]
    g = torch.exp(-2.0 * (math.pi * SIGMA) ** 2 * (ky ** 2 + kx ** 2))
    h = 1.0 - g
    power = (spec.real ** 2 + spec.imag ** 2) / float(ny * nx) ** 2

    def mom(w):
        return torch.sum(w * power, dim=(-2, -1)).mean(dim=-1)

    m, a, b, c = mom(h ** 2), mom((h * g) ** 2), mom(h ** 3 * g), mom(h ** 4)
    tgt = target.double()
    goal = torch.clamp(tgt, min=floor)
    s = (-b + torch.sqrt(torch.clamp(b * b + c * (goal - a), min=0.0))) \
        / torch.clamp(c, min=1e-12)
    s = torch.clamp(s, 0.25, 3.0)
    s = torch.where((tgt <= floor) & (m <= floor), torch.ones_like(s), s)
    out = torch.fft.ifft2(spec * (g + s[:, None, None, None] * h)).real
    out = torch.where(finite, out, y)
    return out.float().permute(1, 2, 3, 0)
