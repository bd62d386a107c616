"""Patch tiling planner.

A copy of ``windtpu/infer/tiling.py``; tests/test_torch_copies.py pins it
to the original bit for bit.

Host-side arithmetic deciding where the (sequence_length x 96 x 96) patch
cubes sit on the high-res domain.  The coverage math reproduces the
reference exactly (api.py:98-116): number of rows/columns interpolates
between "just cover" and "every offset" with overlap_factor^2, leftover
pixels are distributed one-per-slot from the second slice onward, and the
time axis is chunked into floor(T / sequence_length) independent cubes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    image_size: int
    sequence_length: int
    pixels_lat: int
    pixels_lon: int
    time_window: int
    starts_x: Tuple[int, ...]   # lon offsets of each column of patches
    starts_y: Tuple[int, ...]   # lat offsets of each row of patches
    num_time_chunks: int

    @property
    def num_patches(self) -> int:
        return len(self.starts_x) * len(self.starts_y) * self.num_time_chunks

    def patch_origins(self) -> np.ndarray:
        """(N, 3) int array of (sx, sy, time_chunk) per patch, in the
        reference's iteration order (x-major, then y, then time —
        api.py:117-123)."""
        out = [(sx, sy, k)
               for sx in self.starts_x
               for sy in self.starts_y
               for k in range(self.num_time_chunks)]
        return np.asarray(out, dtype=np.int32)


def _distribute(leftovers: int, slots: int) -> np.ndarray:
    """Cumulative one-pixel shifts: the first slice stays at 0, the next
    ``leftovers`` slices each shift one extra pixel (api.py:112-116)."""
    return np.concatenate(
        [[0], np.ones(leftovers), np.zeros(slots - leftovers - 1)]
    ).cumsum()


def plan_tiling(
    pixels_lat: int,
    pixels_lon: int,
    time_window: int,
    image_size: int = 96,
    sequence_length: int = 24,
    overlap_factor: float = 0.05,
) -> TilingPlan:
    if not 0 <= overlap_factor <= 1:
        raise ValueError("overlap_factor must be in [0, 1]")
    if pixels_lon < image_size:
        raise RuntimeError(
            f"Lon dimension too small: got {pixels_lon} pixels, need at "
            f"least {image_size}")
    if pixels_lat < image_size:
        raise RuntimeError(
            f"Lat dimension too small: got {pixels_lat} pixels, need at "
            f"least {image_size}")
    if time_window < sequence_length:
        raise RuntimeError(
            f"Need at least {sequence_length} time steps, got {time_window}")

    min_cols = math.ceil(pixels_lon / image_size)
    max_cols = pixels_lon - image_size
    min_rows = math.ceil(pixels_lat / image_size)
    max_rows = pixels_lat - image_size
    # Clamp to >=1: when a dimension equals image_size exactly, min=1 and
    # max=0 make the blend formula go to floor(1 - f^2) = 0 and the
    # planner would build a negative-length shift array (the guard above
    # explicitly allows pixels == image_size, which needs exactly 1 tile).
    ncols = max(1, math.floor(
        min_cols + overlap_factor**2 * (max_cols - min_cols)))
    nrows = max(1, math.floor(
        min_rows + overlap_factor**2 * (max_rows - min_rows)))

    def starts(npatches: int, pixels: int) -> Tuple[int, ...]:
        if npatches == 1:
            return (0,)
        dist = (pixels - image_size) // (npatches - 1)
        leftovers = pixels - ((npatches - 1) * dist + image_size)
        shifts = _distribute(leftovers, npatches)
        return tuple(int(i * dist + s) for i, s in zip(range(npatches), shifts))

    return TilingPlan(
        image_size=image_size,
        sequence_length=sequence_length,
        pixels_lat=pixels_lat,
        pixels_lon=pixels_lon,
        time_window=time_window,
        starts_x=starts(ncols, pixels_lon),
        starts_y=starts(nrows, pixels_lat),
        num_time_chunks=time_window // sequence_length,
    )
