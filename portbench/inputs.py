"""Inputs made from ``--seed``, handed alike to the program and to the
reference: ERA5 days and a DEM for the downscale, weights and batches for
training.  The same seed gives the same inputs."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness import subseed


def era5_days(seed: int, days: int, nlat: int, nlon: int, hours: int,
              lat0: float = 47.0, lon0: float = 5.0) -> List[Dict]:
    """``days`` ERA5 days of 10 m winds on one 0.25 deg box (latitude
    descending): u about 3 m/s and v about 0 m/s with unit noise, drawn
    from ``seed`` day by day."""
    lat = lat0 - 0.25 * np.arange(nlat)
    lon = lon0 + 0.25 * np.arange(nlon)
    out = []
    for d in range(days):
        rng = np.random.default_rng(subseed(seed, 1, d))
        shape = (hours, nlat, nlon)
        out.append({
            "u10": (3.0 + rng.standard_normal(shape)).astype(np.float32),
            "v10": rng.standard_normal(shape).astype(np.float32),
            "latitude": lat, "longitude": lon,
            "time": (np.datetime64("2016-04-01T00", "h") + np.timedelta64(
                24 * d, "h") + np.arange(hours).astype("timedelta64[h]"))})
    return out


def dem(seed: int, nlat: int, nlon: int, lat0: float = 47.0,
        lon0: float = 5.0) -> Dict:
    """A 0.01 deg DEM covering the box: a coarse random relief upsampled
    10x plus roughness, in metres."""
    rng = np.random.default_rng(subseed(seed, 2))
    ny, nx = 10 * (nlat + 2), 10 * (nlon + 2)
    coarse = 700.0 * rng.standard_normal((nlat + 2, nlon + 2))
    band = 1500.0 + np.kron(coarse, np.ones((10, 10))) \
        + 50.0 * rng.standard_normal((ny, nx))
    return {"band": band.astype(np.float32),
            "y": lat0 + 0.25 - 0.01 * (np.arange(ny) + 0.5),
            "x": lon0 - 0.25 + 0.01 * (np.arange(nx) + 0.5)}


def weights(shapes: Dict[str, Tuple[int, ...]],
            state_shapes: Dict[str, Tuple[int, ...]], seed: int,
            device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Parameters and state from ``seed`` on ``device`` in two draws:
    Glorot-uniform kernels (recurrent ones too), zero biases, unit scales
    and forget biases, unit-normal spectral-norm ``u``, zero running means
    and unit running variances."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 3))
    kernels = [k for k in shapes if k.endswith(("kernel",))]
    flat = torch.rand(sum(math.prod(shapes[k]) for k in kernels),
                      generator=gen, device=device)
    us = [k for k in state_shapes if k.endswith(".u")]
    normal = torch.randn(max(1, sum(math.prod(state_shapes[k]) for k in us)),
                         generator=gen, device=device)
    params, state = {}, {}
    at = 0
    for k in kernels:
        shape = shapes[k]
        n = math.prod(shape)
        fan_in = math.prod(shape[:-1])
        fan_out = math.prod(shape[:-2]) * shape[-1]
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        params[k] = (flat[at:at + n] * (2 * lim) - lim).reshape(shape)
        at += n
    for k, shape in shapes.items():
        if k not in params:
            leaf = k.rsplit(".", 1)[-1]
            fill = 1.0 if leaf in ("scale", "forget_bias") else 0.0
            params[k] = torch.full(shape, fill, device=device)
    at = 0
    for k, shape in state_shapes.items():
        if k in us:
            n = math.prod(shape)
            state[k] = normal[at:at + n].reshape(shape).clone()
            at += n
        else:
            state[k] = torch.full(shape, 1.0 if k.endswith(".var") else 0.0,
                                  device=device)
    return params, state


def train_batches(seed: int, n: int, shape: Tuple[int, ...], in_ch: int,
                  out_ch: int, device) -> List[Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """``n`` distinct (low_res, high_res) batches of ``shape`` (B, T, H, W):
    unit-normal inputs and wind-like targets of a few m/s, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 4))
    return [(torch.randn(shape + (in_ch,), generator=gen, device=device),
             4.0 * torch.randn(shape + (out_ch,), generator=gen,
                               device=device))
            for _ in range(n)]
