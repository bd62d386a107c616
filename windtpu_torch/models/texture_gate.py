"""Flow-conditional texture gate (counterpart of
``windtpu/models/texture_gate.py``): post-hoc per-channel rescaling of the
output's high-pass band toward a predicted truth energy.

Two halves, as in the JAX package:

* device (``torch.fft``, f32 / complex64): the intensive features of the
  input field (:func:`_features`), the MLP's energy prediction
  (:func:`predict_log_energy`, differentiable in ``w1..b3``: the fit
  minimises its squared error), the gains and the gated field
  (:func:`gate_gains`, :func:`apply_gate`), and
  :func:`apply_gate_targeted`, which gates the stitched canvas toward
  energies predicted elsewhere, where the canvas already lives;
* host (numpy): the energy prediction from a dozen intensive statistics of
  the input field (:func:`predict_log_energy_np`, what ``api.predict``
  runs), and the whole gate on a host canvas
  (:func:`apply_gate_targeted_np`) — copies of the JAX package's numpy
  twins.

The band split is the spectral Gaussian of sigma = 7 px; the gain solves
E(s) = a + 2 b s + c s^2 = max(target, floor) and is clipped to
[0.25, 3]; channels where both the prediction and the measurement sit
under the floor keep gain 1.

Parameters (:data:`Params`) are a dict of numpy arrays, as
:func:`load_gate_npz` returns them; the device functions take tensors as
well (a fit's trainable ones), and move each to the input's device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from windtpu_torch.utils.logging import span

Params = Dict[str, Union[np.ndarray, torch.Tensor]]

SIGMA = 7.0
S_MIN, S_MAX = 0.25, 3.0
N_FEATURES = 11


# -- device side (torch) -----------------------------------------------------

def _gauss_multiplier(ny: int, nx: int, device, sigma: float = SIGMA
                      ) -> torch.Tensor:
    """Spectral Gaussian G(k) on the full fft2 grid, shape (ny, nx), f32."""
    ky = torch.fft.fftfreq(ny, dtype=torch.float32, device=device)[:, None]
    kx = torch.fft.fftfreq(nx, dtype=torch.float32, device=device)[None, :]
    return torch.exp(-2.0 * (math.pi * sigma) ** 2 * (ky ** 2 + kx ** 2))


def _param(params: Params, key: str, like: torch.Tensor) -> torch.Tensor:
    """``params[key]`` as f32 on ``like``'s device (a tensor keeps its
    graph)."""
    return torch.as_tensor(params[key], dtype=torch.float32,
                           device=like.device)


def _spectral_lowpass(field: torch.Tensor, sigma: float = SIGMA
                      ) -> torch.Tensor:
    """Periodic Gaussian blur over the last two axes."""
    g = _gauss_multiplier(field.shape[-2], field.shape[-1], field.device,
                          sigma)
    return torch.fft.ifft2(torch.fft.fft2(field.float()) * g).real


def _hp_energy(field: torch.Tensor) -> torch.Tensor:
    """Mean squared high-pass content over (T, H, W): the metric."""
    hp = field - _spectral_lowpass(field)
    return torch.mean(hp * hp, dim=(-3, -2, -1))


def _features(low: torch.Tensor) -> torch.Tensor:
    """Per-sample intensive features of (..., T, H, W, 3) (blurred u,
    blurred v, elevation / 1e3) -> (..., 2, 11): row c describes output
    channel c, with its own stats, the other channel's and the shared
    ones (speed, terrain spread, energy and roughness)."""
    u, v, elev = low[..., 0], low[..., 1], low[..., 2]
    red = (-3, -2, -1)

    def std(x):
        return torch.std(x, dim=red, correction=0)

    def chan_stats(x):
        return [torch.mean(torch.abs(x), dim=red), std(x),
                torch.log(_hp_energy(x) + 1e-8)]

    su, sv = chan_stats(u), chan_stats(v)
    speed = torch.mean(torch.sqrt(u * u + v * v), dim=red)
    gy = elev - torch.roll(elev, 1, dims=-2)
    gx = elev - torch.roll(elev, 1, dims=-1)
    grad2 = gy * gy + gx * gx
    rough = [torch.mean(torch.sqrt(grad2), dim=red),
             torch.log(torch.mean(grad2, dim=red) + 1e-10)]
    shared = [speed, std(elev), torch.log(_hp_energy(elev) + 1e-8)] + rough
    fu = torch.stack(su + sv + shared, dim=-1)
    fv = torch.stack(sv + su + shared, dim=-1)
    return torch.stack([fu, fv], dim=-2)


def init_params(generator: torch.Generator, hidden: int = 32) -> Params:
    """Fresh gate parameters (MLP 11 -> hidden -> hidden -> 1) drawn from
    ``generator``: normal kernels scaled by 1/sqrt(fan-in), zero biases.
    ``f_mu``/``f_sd`` (feature normalisation, 0 and 1 here) and ``floor``
    (1e-3) are calibration constants that a fit fills in."""
    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x / math.sqrt(fan_in)).cpu().numpy()

    zeros = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    return {
        "w1": normal((N_FEATURES, hidden), N_FEATURES),
        "b1": zeros(hidden),
        "w2": normal((hidden, hidden), hidden),
        "b2": zeros(hidden),
        "w3": normal((hidden, 1), hidden),
        "b3": zeros(1),
        "f_mu": zeros(N_FEATURES),
        "f_sd": np.ones((N_FEATURES,), np.float32),
        "floor": np.asarray(1e-3, np.float32),
    }


def predict_log_energy(params: Params, low: torch.Tensor) -> torch.Tensor:
    """Predicted log truth high-pass energy of (..., T, H, W, 3), shape
    (..., 2), on ``low``'s device; differentiable in the parameters."""
    low = torch.as_tensor(low, dtype=torch.float32)
    p = {k: _param(params, k, low) for k in
         ("w1", "b1", "w2", "b2", "w3", "b3", "f_mu", "f_sd")}
    f = (_features(low) - p["f_mu"]) / p["f_sd"]
    h = torch.tanh(f @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


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


def _gains(spec: torch.Tensor, g: torch.Tensor, pred_energy: torch.Tensor,
           floor: torch.Tensor) -> torch.Tensor:
    """Per-(..., channel) gains toward ``pred_energy``; 1 where both the
    prediction and the measured energy sit under the floor."""
    m, a, b, c = _band_moments(spec, g)
    target = torch.maximum(pred_energy, floor)
    s = _solve_gain(target, m, a, b, c, floor)
    return torch.where((pred_energy <= floor) & (m <= floor),
                       torch.ones_like(s), s)


def _blend(spec: torch.Tensor, g: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """The field G*y + s*(1-G)*y from its fft2 ``spec``."""
    mult = g + s[..., None, None, None] * (1.0 - g)
    return torch.fft.ifft2(spec * mult).real


def _gate(params: Params, low: torch.Tensor, fake: torch.Tensor,
          want_field: bool) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    yc = torch.movedim(fake, -1, -4).float()   # (..., 2, T, H, W)
    g = _gauss_multiplier(yc.shape[-2], yc.shape[-1], yc.device)
    spec = torch.fft.fft2(yc)
    s = _gains(spec, g, torch.exp(predict_log_energy(params, low)),
               _param(params, "floor", yc))
    if not want_field:
        return None, s
    return torch.movedim(_blend(spec, g, s), -4, -1), s


def gate_gains(params: Params, low: torch.Tensor,
               fake: torch.Tensor) -> torch.Tensor:
    """Per-(sample, channel) high-pass gains, shape (..., 2)."""
    return _gate(params, low, fake, want_field=False)[1]


def apply_gate(params: Params, low: torch.Tensor,
               fake: torch.Tensor) -> torch.Tensor:
    """Gate ``fake`` (..., T, H, W, 2) conditioned on ``low``
    (..., T, H, W, 3): the spectral blend G*fake + s*(1-G)*fake with each
    (sample, channel)'s exact gain, on ``fake``'s device."""
    return _gate(params, low, fake, want_field=True)[0]


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
    s = _gains(spec, g, pred_energy, floor)
    out = torch.where(finite, _blend(spec, g, s), yc)
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
    with span("gate.features"):
        f = (features_np(low) - p["f_mu"]) / p["f_sd"]
    with span("gate.mlp"):
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


def save_gate_npz(path, params: Params) -> None:
    """Write ``params`` (arrays or tensors) as the ``.npz`` both packages'
    ``load_gate_npz`` read."""
    np.savez(path, **{k: (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
                      for k, v in params.items()})


def load_gate_npz(path) -> Params:
    """Gate calibration (w1..b3, f_mu, f_sd, floor) as numpy arrays."""
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}
