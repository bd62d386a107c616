"""Bundled grid assets.

A copy of ``windtpu/assets/__init__.py`` (pure numpy), kept so the port
imports nothing of the JAX package; tests/test_torch_copies.py pins it to
the original.  The bundled weights stay where they are, under
``windtpu/assets/weights``, and are read in place by path.

The reference packages ``switzerland_cosmo_map.nc`` — the COSMO-1 analysis
grid over Switzerland (294 x 429 cells, Swiss CH1903/LV03 projected
x_1/y_1 coordinates plus 2-D lat_1/lon_1; SURVEY.md §2 "Grid template
asset").  The original data blob is not redistributable here, so
:func:`swiss_cosmo_grid` reconstructs the grid analytically from its four
defining scalars (verified against the readable reference asset with h5py):
CH1903/LV03 eastings 439 000..867 000 m and northings 40 500..333 500 m at
exactly 1 000 m spacing, with lat/lon computed by the official approximate
CH1903 -> WGS84 conversion formulas (swisstopo).  Cell centers match the
reference asset to within the CH1903-approximation tolerance (~1e-3 deg,
i.e. well under 100 m); ``tests/test_assets.py`` checks this directly
against the reference asset when that file is present.
"""

from __future__ import annotations

import numpy as np

from windtpu_torch.io.dataset import DataArray, Dataset

# Reference asset dimensions (h5dump-verified in SURVEY.md §2).
NY, NX = 294, 429
# CH1903/LV03 bounds of the COSMO-1 Swiss window: exactly 1 km spacing.
# Four scalars read off the reference asset (not a blob copy):
# x_1 = 439000..867000 step 1000 (429 cells), y_1 = 40500..333500 step
# 1000 (294 cells).
X_MIN, X_MAX = 439000.0, 867000.0    # easting  (y-axis in CH1903 naming)
Y_MIN, Y_MAX = 40500.0, 333500.0     # northing


def _ch1903_to_wgs84(e: np.ndarray, n: np.ndarray):
    """Approximate CH1903 -> WGS84 (swisstopo series expansion)."""
    y = (e - 600000.0) / 1e6
    x = (n - 200000.0) / 1e6
    lon = (2.6779094 + 4.728982 * y + 0.791484 * y * x
           + 0.1306 * y * x**2 - 0.0436 * y**3) * 100.0 / 36.0
    lat = (16.9023892 + 3.238272 * x - 0.270978 * y**2
           - 0.002528 * x**2 - 0.0447 * y**2 * x - 0.0140 * x**3) \
        * 100.0 / 36.0
    return lon, lat


def swiss_cosmo_grid() -> Dataset:
    """294 x 429 Swiss 1-km grid template with (x_1, y_1) CH1903 coords and
    2-D (lat_1, lon_1), matching the bundled reference asset's cell centers
    to the CH1903-approximation tolerance (~1e-3 deg)."""
    x_1 = np.linspace(X_MIN, X_MAX, NX)
    y_1 = np.linspace(Y_MIN, Y_MAX, NY)
    ee, nn = np.meshgrid(x_1, y_1)
    lon_1, lat_1 = _ch1903_to_wgs84(ee, nn)
    return Dataset(
        {},
        {
            "x_1": DataArray(("x_1",), x_1),
            "y_1": DataArray(("y_1",), y_1),
            "lon_1": DataArray(("y_1", "x_1"), lon_1),
            "lat_1": DataArray(("y_1", "x_1"), lat_1),
        },
    )
