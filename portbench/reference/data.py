"""The training batches of ``train_main --synthetic``, worked out again in
numpy: the synthetic days (a smooth seeded field per variable, a per-hour
offset and pixel noise), then for batch ``index`` a stream seeded from the
pipeline's seed and the index, which draws per row a (time, y, x) crop,
z-scores the input crop per channel (NaN-aware), and draws two flips and a
quarter-turn count that act on input and target alike.  Batch ``index``
comes from day ``index`` modulo the number of days, in date order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def synthetic_day(date: str, variables: Sequence[str], seed: int,
                  ny: int = 64, nx: int = 64, nt: int = 24
                  ) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed + int(date) % 100003)
    yy, xx = np.meshgrid(np.linspace(0, 4, ny), np.linspace(0, 4, nx),
                         indexing="ij")
    out = {}
    for i, v in enumerate(variables):
        phase = rng.uniform(0, 2 * np.pi)
        base = np.sin(xx * (1 + i * 0.3) + phase) \
            + np.cos(yy * (1.3 + i * 0.2))
        t_mod = rng.standard_normal((nt, 1, 1)) * 0.5
        noise = rng.standard_normal((nt, ny, nx)) * 0.1
        out[v] = (base[None] + t_mod + noise).astype(np.float32)
    return out


def item_stream(seed: int, index: int) -> np.random.RandomState:
    return np.random.RandomState((int(seed) + 0x9E3779B1 * (index + 1))
                                 % (2 ** 32))


def _crop(day, t0, y0, x0, variables, seq, patch):
    return np.stack([day[v][t0:t0 + seq, y0:y0 + patch, x0:x0 + patch]
                     for v in variables], axis=-1)


def batch(days: List[Tuple[Dict, Dict]], index: int, seed: int, rows: int,
          seq: int, patch: int, in_vars, out_vars):
    """Batch ``index`` as (input (B, T, P, P, C_in), target) float32."""
    day_x, day_y = days[index % len(days)]
    rng = item_stream(seed, index)
    nt, ny, nx = next(iter(day_x.values())).shape
    xs, ys = [], []
    for _ in range(rows):
        t0 = rng.randint(0, nt + 1 - seq)
        y0 = rng.randint(0, ny + 1 - patch)
        x0 = rng.randint(0, nx + 1 - patch)
        x = _crop(day_x, t0, y0, x0, in_vars, seq, patch)
        x = (x - np.nanmean(x, axis=(0, 1, 2), keepdims=True)) \
            / np.nanstd(x, axis=(0, 1, 2), keepdims=True)
        y = _crop(day_y, t0, y0, x0, out_vars, seq, patch)
        if rng.randint(2):
            x, y = np.flip(x, axis=1), np.flip(y, axis=1)
        if rng.randint(2):
            x, y = np.flip(x, axis=2), np.flip(y, axis=2)
        k = rng.randint(4)
        if k:
            x, y = np.rot90(x, k=k, axes=(1, 2)), np.rot90(y, k=k, axes=(1, 2))
        xs.append(x)
        ys.append(y)
    return (np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32))
