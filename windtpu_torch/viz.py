"""Plotting utilities (host-side, matplotlib; cartopy optional): a copy
of ``windtpu/viz.py``, which imports no JAX.

Dual-panel u10/v10 maps with symmetric colorbars, and a log-normed DEM
terrain plot, of the port's :class:`windtpu_torch.io.dataset.Dataset` (or
any object with the same ``coords`` / ``[var].values`` surface, such as
``api.downscale``'s result).  Cartopy map furniture (borders, coastlines,
rivers) is added when cartopy is importable and skipped otherwise.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np


def _try_cartopy():
    try:
        import cartopy  # noqa: F401
        import cartopy.crs as ccrs

        class HigherResPlateCarree(ccrs.PlateCarree):
            """PlateCarree with 100x finer interpolation threshold, for
            smooth high-res boundary lines (reference
            data_processing.py:13-20)."""

            @property
            def threshold(self):
                return super().threshold / 100

        return cartopy, HigherResPlateCarree
    except ImportError:
        return None, None


def plot_wind_fields(ds, cmap: str = "bwr", title: str = "",
                     range_lon: Optional[Tuple[float, float]] = None,
                     range_lat: Optional[Tuple[float, float]] = None,
                     time_index: int = 0):
    """Two panels (u10, v10) with symmetric color range per panel."""
    import matplotlib.pyplot as plt

    cartopy, HRPC = _try_cartopy()
    subplot_kw = {"projection": HRPC()} if HRPC else {}
    fig, axes = plt.subplots(1, 2, figsize=(15, 5),
                             constrained_layout=True, subplot_kw=subplot_kw)
    lon = ds.coords["lon_1"].values
    lat = ds.coords["lat_1"].values
    for ax, var in zip(axes, ["u10", "v10"]):
        vals = np.asarray(ds[var].values)
        if vals.ndim == 3:
            vals = vals[time_index]
        # `or 1.0` guards the all-zero field; NaN is truthy, so an all-NaN
        # slice (e.g. uncovered engine pixels) needs its own fallback.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            bound = np.nanmax(np.abs(vals)) if np.isfinite(vals).any() else 1.0
        bound = bound or 1.0
        text = "U-component" if var == "u10" else "V-component"
        kwargs = {}
        if HRPC:
            kwargs["transform"] = HRPC()
        pcm = ax.pcolormesh(lon, lat, vals, cmap=cmap, vmin=-bound,
                            vmax=bound, **kwargs)
        ax.set_title(title)
        fig.colorbar(pcm, ax=ax, orientation="horizontal", shrink=0.5,
                     label=f"10-meter {text} (m.s-1)")
        if range_lon is not None and range_lat is not None:
            if HRPC:
                ax.set_extent([range_lon[0], range_lon[1],
                               range_lat[0], range_lat[1]])
            else:
                ax.set_xlim(range_lon)
                ax.set_ylim(range_lat)
        if cartopy:
            borders = cartopy.feature.NaturalEarthFeature(
                category="cultural", name="admin_0_boundary_lines_land",
                scale="10m", facecolor="none")
            ax.add_feature(borders, edgecolor="black")
            ax.coastlines(resolution="10m", color="black")
    return fig


def plot_elevation(raster, range_lon=None, range_lat=None):
    """Log-normed terrain map of the DEM raster dataset."""
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    cartopy, HRPC = _try_cartopy()
    subplot_kw = {"projection": HRPC()} if HRPC else {}
    fig, ax = plt.subplots(constrained_layout=True, figsize=(7.5, 5),
                           subplot_kw=subplot_kw)
    dem = np.asarray(raster["band_data"].values)[0]
    x = raster.coords["x"].values
    y = raster.coords["y"].values
    dem_pos = np.clip(dem, 1.0, None)
    kwargs = {"transform": HRPC()} if HRPC else {}
    pcm = ax.pcolormesh(x, y, dem_pos, cmap=plt.cm.terrain,
                        norm=LogNorm(vmin=58, vmax=4473), **kwargs)
    fig.colorbar(pcm, ax=ax, orientation="horizontal", shrink=0.7,
                 label="terrain height (m)")
    ax.set_title("DEM")
    if cartopy:
        ax.add_feature(cartopy.feature.RIVERS.with_scale("10m"),
                       color=plt.cm.terrain(0.0))
        ax.add_feature(cartopy.feature.LAKES.with_scale("10m"),
                       color=plt.cm.terrain(0.0))
        ax.add_feature(cartopy.feature.BORDERS.with_scale("10m"),
                       color="black")
    if range_lon is not None and range_lat is not None:
        if HRPC:
            ax.set_extent([range_lon[0], range_lon[1],
                           range_lat[0], range_lat[1]])
        else:
            ax.set_xlim(range_lon)
            ax.set_ylim(range_lat)
    return fig
