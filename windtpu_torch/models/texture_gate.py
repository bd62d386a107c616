"""Flow-conditional texture gate (counterpart of
``windtpu/models/texture_gate.py``): post-hoc per-channel rescaling of the
output's high-pass band toward a predicted truth energy.

Two halves, as in the JAX package's inference path:

* host (numpy): the energy prediction from a dozen intensive statistics of
  the input field (:func:`predict_log_energy_np`), and the whole gate on a
  host canvas (:func:`apply_gate_targeted_np`) — copies of the JAX
  package's numpy twins;
* device (``torch.fft``): :func:`apply_gate_targeted`, which measures the
  stitched canvas's band moments and rescales its high-pass band with the
  closed-form gain, where the canvas already lives.

The band split is the spectral Gaussian of sigma = 7 px; the gain solves
E(s) = a + 2 b s + c s^2 = max(target, floor) and is clipped to
[0.25, 3]; channels where both the prediction and the measurement sit
under the floor keep gain 1.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

Params = Dict[str, np.ndarray]

SIGMA = 7.0
S_MIN, S_MAX = 0.25, 3.0


# -- device side (torch) -----------------------------------------------------

def _gauss_multiplier(ny: int, nx: int, device, sigma: float = SIGMA
                      ) -> torch.Tensor:
    """Spectral Gaussian G(k) on the full fft2 grid, shape (ny, nx), f32."""
    ky = torch.fft.fftfreq(ny, dtype=torch.float32, device=device)[:, None]
    kx = torch.fft.fftfreq(nx, dtype=torch.float32, device=device)[None, :]
    return torch.exp(-2.0 * (math.pi * sigma) ** 2 * (ky ** 2 + kx ** 2))


def _band_moments(spec: torch.Tensor, g: torch.Tensor):
    """(m, a, b, c) per (..., channel) from the fft2 ``spec`` of
    (..., T, H, W): with H = 1 - G, the metric energy m = <|HY|^2> and the
    quadratic E(s) = a + 2 b s + c s^2 of the gated field's high-pass
    energy (Parseval, 1/N^2 per frame, mean over T)."""
    h = 1.0 - g
    n2 = float(spec.shape[-2] * spec.shape[-1]) ** 2
    p = (spec.real ** 2 + spec.imag ** 2) / n2

    def mom(w):
        return torch.mean(torch.sum(w * p, dim=(-2, -1)), dim=-1)

    return mom(h ** 2), mom((h * g) ** 2), mom(h ** 3 * g), mom(h ** 4)


def _solve_gain(target, m, a, b, c, floor):
    """Gain s with E(s) = target, clipped to [S_MIN, S_MAX]."""
    disc = torch.clamp(b * b + c * (target - a), min=0.0)
    s = (-b + torch.sqrt(disc)) / torch.clamp(c, min=1e-12)
    return torch.clamp(s, S_MIN, S_MAX)


def apply_gate_targeted(pred_energy: torch.Tensor, floor: torch.Tensor,
                        fake: torch.Tensor) -> torch.Tensor:
    """Gate ``fake`` (..., T, H, W, 2) toward the target energies
    ``pred_energy`` (broadcasting against the (..., 2) gain shape).
    NaN cells are zeroed for the spectral ops and restored afterwards."""
    yc = torch.movedim(fake, -1, -4).float()
    finite = torch.isfinite(yc)
    yz = torch.where(finite, yc, torch.zeros_like(yc))
    g = _gauss_multiplier(yz.shape[-2], yz.shape[-1], yz.device)
    spec = torch.fft.fft2(yz)
    m, a, b, c = _band_moments(spec, g)
    target = torch.maximum(pred_energy, floor)
    s = _solve_gain(target, m, a, b, c, floor)
    s = torch.where((pred_energy <= floor) & (m <= floor),
                    torch.ones_like(s), s)
    mult = g + s[..., None, None, None] * (1.0 - g)
    out = torch.fft.ifft2(spec * mult).real
    out = torch.where(finite, out, yc)
    return torch.movedim(out, -4, -1)


# -- host side (numpy copies of the JAX package's twins) ----------------------

def _np_gauss(ny, nx, sigma=SIGMA):
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.fftfreq(nx)[None, :]
    return np.exp(-2.0 * (np.pi * sigma) ** 2
                  * (ky ** 2 + kx ** 2)).astype(np.float32)


def _np_hp_energy(field):
    """Metric high-pass energy over the last 3 axes (T, H, W), from the
    power spectrum: mean_x |Hy|^2 = sum_k H(k)^2 |Y_k|^2 / N^2 per frame."""
    field = np.asarray(field, np.float32)
    ny, nx = field.shape[-2], field.shape[-1]
    h = 1.0 - _np_gauss(ny, nx)
    w = h[:, :nx // 2 + 1].copy()
    # rfft2 drops conjugate-symmetric columns; double their weight
    # (first column and, for even nx, the Nyquist column are unique).
    w[:, 1:(nx + 1) // 2] *= np.sqrt(2.0)
    w2 = w ** 2
    n2 = float(ny * nx) ** 2
    flat = field.reshape(-1, ny, nx)
    e = np.empty(flat.shape[0], np.float64)
    for f in range(flat.shape[0]):  # frame at a time: fft promotes to c128
        spec = np.fft.rfft2(flat[f])
        e[f] = np.sum((spec.real ** 2 + spec.imag ** 2) * w2) / n2
    return e.reshape(field.shape[:-2]).mean(axis=-1)


def features_np(low) -> np.ndarray:
    """Per-sample intensive features of (..., T, H, W, 3) -> (..., 2, 11)."""
    low = np.asarray(low, np.float32)
    u, v, elev = low[..., 0], low[..., 1], low[..., 2]
    red = (-3, -2, -1)

    def chan_stats(x):
        return [np.mean(np.abs(x), axis=red), np.std(x, axis=red),
                np.log(_np_hp_energy(x) + 1e-8)]

    su, sv = chan_stats(u), chan_stats(v)
    speed = np.mean(np.sqrt(u * u + v * v), axis=red)
    gy = elev - np.roll(elev, 1, axis=-2)
    gx = elev - np.roll(elev, 1, axis=-1)
    grad2 = gy * gy + gx * gx
    rough = [np.mean(np.sqrt(grad2), axis=red),
             np.log(np.mean(grad2, axis=red) + 1e-10)]
    shared = [speed, np.std(elev, axis=red),
              np.log(_np_hp_energy(elev) + 1e-8)] + rough
    fu = np.stack(su + sv + shared, axis=-1)
    fv = np.stack(sv + su + shared, axis=-1)
    return np.stack([fu, fv], axis=-2)


def predict_log_energy_np(params: Params, low) -> np.ndarray:
    """Predicted log truth high-pass energy, shape (..., 2)."""
    p = {k: np.asarray(v) for k, v in params.items()}
    f = (features_np(low) - p["f_mu"]) / p["f_sd"]
    h = np.tanh(f @ p["w1"] + p["b1"])
    h = np.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def apply_gate_targeted_np(pred_energy, floor, fake) -> np.ndarray:
    """Host twin of :func:`apply_gate_targeted`, one (sample, channel)
    frame stack at a time (O(T * H * W) working memory)."""
    fake = np.asarray(fake, np.float32)
    lead = fake.shape[:-4]
    t, ny, nx = fake.shape[-4:-1]
    g = _np_gauss(ny, nx)
    h = 1.0 - g
    n2 = float(ny * nx) ** 2
    pred_energy = np.broadcast_to(np.asarray(pred_energy, np.float32),
                                  lead + (2,))
    floor = float(floor)

    out = np.empty_like(fake)
    flat = fake.reshape((-1,) + fake.shape[-4:])
    oflat = out.reshape((-1,) + fake.shape[-4:])
    pflat = pred_energy.reshape(-1, 2)
    wm, wa = h ** 2, (h * g) ** 2
    wb, wc = h ** 3 * g, h ** 4
    for i in range(flat.shape[0]):
        for ch in (0, 1):
            m = a = b = c = 0.0
            for f in range(t):
                spec = np.fft.fft2(np.nan_to_num(flat[i, f, ..., ch]))
                p = (spec.real ** 2 + spec.imag ** 2) / n2
                m += float(np.sum(wm * p))
                a += float(np.sum(wa * p))
                b += float(np.sum(wb * p))
                c += float(np.sum(wc * p))
            m, a, b, c = m / t, a / t, b / t, c / t
            pe = float(pflat[i, ch])
            target = max(pe, floor)
            disc = max(b * b + c * (target - a), 0.0)
            s = (-b + np.sqrt(disc)) / max(c, 1e-12)
            s = float(np.clip(s, S_MIN, S_MAX))
            if pe <= floor and m <= floor:
                s = 1.0
            mult = g + s * h
            for f in range(t):
                frame = flat[i, f, ..., ch]
                finite = np.isfinite(frame)
                gated = np.fft.ifft2(
                    np.fft.fft2(np.nan_to_num(frame)) * mult
                ).real.astype(np.float32)
                oflat[i, f, ..., ch] = np.where(finite, gated, frame)
    return out


def load_gate_npz(path) -> Params:
    """Gate calibration (w1..b3, f_mu, f_sd, floor) as numpy arrays."""
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}
