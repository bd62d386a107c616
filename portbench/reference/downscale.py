"""The published inference path (reference ``api.py:31-135``), written out
again: the ~1 km target grid (the ERA5 box upsampled 26x in latitude and
18x in longitude by linspace), nearest-neighbour regridding of u10, v10
and the DEM onto it, the tiling plan, NaN-aware normalisation statistics
per (longitude in the patch, channel) over all patches, the generator on
groups of 16 lat-reversed patches with one noise draw per group, the 2 px
border crop, the overlap mean, the trim to the covered hours and the
texture gate toward energies predicted from the input field.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import gate as G
from portbench.reference import networks as N
from portbench.reference.layers import Precision

UP_LAT, UP_LON = 26, 18
CROP = 2


def nearest(grid: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Index of the nearest grid point to each wanted value; a tie goes to
    the lower coordinate, values beyond an end to that end."""
    flip = len(grid) > 1 and grid[0] > grid[-1]
    g = grid[::-1] if flip else grid
    pos = np.clip(np.searchsorted(g, want), 1, len(g) - 1)
    idx = np.where(np.abs(want - g[pos - 1]) <= np.abs(g[pos] - want),
                   pos - 1, pos)
    idx = np.where(want <= g[0], 0, np.where(want >= g[-1], len(g) - 1, idx))
    return len(grid) - 1 - idx if flip else idx


def merged_field(era5: Dict, dem: Dict) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """(T, lat, lon, 3) field of u10, v10 and elevation / 1e3 on the target
    grid, and the grid's lat and lon. ``era5``: u10, v10 (T, lat, lon),
    latitude, longitude; ``dem``: band (y, x), y, x."""
    lat, lon = era5["latitude"], era5["longitude"]
    new_lon = np.linspace(lon.min(), lon.max(), UP_LON * len(lon))
    new_lat = np.linspace(lat.min(), lat.max(), UP_LAT * len(lat))
    iy = nearest(lat.astype(np.float64), new_lat)
    ix = nearest(lon.astype(np.float64), new_lon)
    u = era5["u10"][:, iy][:, :, ix].astype(np.float32)
    v = era5["v10"][:, iy][:, :, ix].astype(np.float32)
    dy = nearest(dem["y"].astype(np.float64), new_lat)
    dx = nearest(dem["x"].astype(np.float64), new_lon)
    elev = dem["band"][dy][:, dx].astype(np.float32) / 1e3
    field = np.stack([u, v, np.broadcast_to(elev, u.shape)], axis=-1)
    return field, new_lat, new_lon


def starts(n_px: int, img: int, overlap: float) -> List[int]:
    lo, hi = math.ceil(n_px / img), n_px - img
    n = max(1, math.floor(lo + overlap ** 2 * (hi - lo)))
    if n == 1:
        return [0]
    dist = (n_px - img) // (n - 1)
    left = n_px - ((n - 1) * dist + img)
    shift = np.concatenate([[0], np.ones(left), np.zeros(n - left - 1)])
    return [int(i * dist + s) for i, s in zip(range(n), shift.cumsum())]


def plan(h: int, w: int, t: int, img: int, seq: int, overlap: float):
    """Patch origins (sx, sy, time chunk), x-major then y then time."""
    return [(sx, sy, k) for sx in starts(w, img, overlap)
            for sy in starts(h, img, overlap) for k in range(t // seq)]


def downscale(era5: Dict, dem: Dict, gen_params, gen_state, gate_params,
              seed: int, prec: Precision, device, img: int = 96,
              seq: int = 24, noise_channels: int = 20,
              noise_std: float = 0.1, group: int = 16,
              overlap: float = 0.05) -> np.ndarray:
    """The gated, trimmed (T', H - 4, W - 4, 2) float32 prediction."""
    field_np, _, _ = merged_field(era5, dem)
    t_all, h, w, c_in = field_np.shape
    target = np.exp(G.predict_log_energy_np(gate_params, field_np))
    origins = plan(h, w, t_all, img, seq, overlap)
    n = len(origins)
    pad = (-n) % group
    origins = origins + [origins[-1]] * pad
    valid = [1.0] * n + [0.0] * pad
    field = torch.as_tensor(field_np, device=device)

    def patch(o):
        sx, sy, k = o
        t0 = min(max(k * seq, 0), max(t_all - seq, 0))
        y0 = min(max(sy, 0), max(h - img, 0))
        x0 = min(max(sx, 0), max(w - img, 0))
        return field[t0:t0 + seq, y0:y0 + img, x0:x0 + img].flip(1)

    s = s2 = cnt = 0.0
    for o, wgt in zip(origins, valid):
        x = patch(o)
        ok = (~torch.isnan(x)).float() * wgt
        x0 = torch.nan_to_num(x, nan=0.0)
        s = s + (x0 * ok).sum(dim=(0, 1)).double()
        s2 = s2 + (x0 * x0 * ok).sum(dim=(0, 1)).double()
        cnt = cnt + ok.sum(dim=(0, 1)).double()
    mean = s / torch.clamp(cnt, min=1.0)
    std = torch.sqrt(torch.clamp(s2 / torch.clamp(cnt, min=1.0) - mean ** 2,
                                 min=0.0))
    std = torch.where(std == 0, torch.ones_like(std), std)
    mean, std = mean.float(), std.float()

    canvas = torch.zeros((t_all, h, w, 2), device=device)
    counts = torch.zeros((t_all, h, w, 1), device=device)
    rng = torch.Generator(device=device).manual_seed(int(seed))
    size = img - 2 * CROP
    for g0 in range(0, len(origins), group):
        chunk = origins[g0:g0 + group]
        x = torch.stack([(patch(o) - mean) / std for o in chunk])
        noise = noise_std * torch.randn(
            x.shape[:-1] + (noise_channels,), generator=rng, device=device)
        with torch.no_grad():
            y, _ = N.generator(gen_params, gen_state, x, noise, prec)
        y = y.flip(2)[:, :, CROP:img - CROP, CROP:img - CROP]
        for i, (sx, sy, k) in enumerate(chunk):
            wgt = valid[g0 + i]
            t0 = min(k * seq, t_all - seq)
            y0 = min(max(sy + CROP, 0), h - size)
            x0 = min(max(sx + CROP, 0), w - size)
            canvas[t0:t0 + seq, y0:y0 + size, x0:x0 + size] += wgt * y[i]
            if wgt:
                counts[k * seq:(k + 1) * seq, sy + CROP:sy + img - CROP,
                       sx + CROP:sx + img - CROP] += 1.0
    out = canvas / torch.clamp(counts, min=1.0)
    out = out.masked_fill(counts == 0, float("nan"))
    out = out[:(t_all // seq) * seq, CROP:-CROP, CROP:-CROP]
    out = G.apply_gate_targeted(torch.as_tensor(target, device=device),
                                float(gate_params["floor"]), out)
    return out.cpu().numpy()
