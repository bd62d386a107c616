"""Daily training-file builder.

A copy of ``windtpu/preprocess/daily.py`` (numpy, pandas and scipy), kept
so the port imports nothing of the JAX package; tests/test_torch_copies.py
pins it to the original.

Re-implements the reference's offline preprocessing
(data_processing.py:82-211) on :mod:`windtpu_torch.io` datasets: for each day,
read COSMO-1 targets (U_10M, V_10M), nearest-sample ERA5 surface + z500
variables onto the COSMO 1-km grid, replicate static topo descriptors over
time, derive the wind-terrain exposure predictors, and write
``x_YYYYMMDD.nc`` / ``y_YYYYMMDD.nc``.  Idempotent per day.
"""

from __future__ import annotations

import glob
import os
import pathlib
from typing import Tuple

import numpy as np
import pandas as pd

from windtpu_torch.io.dataset import DataArray, Dataset, open_mfdataset

SURFACE_VARS = ("u10", "v10", "blh", "fsr", "sp")
Z500_VARS = ("z", "vo", "d")
# Matches the reference default (data_processing.py:86-88) INCLUDING the
# ridge index pair — producible here because windtpu's topo job computes
# them (ops/stencil.ridge_index), where the reference's does not.
TOPO_VARS = ("elevation", "tpi_500", "ridge_index_norm", "ridge_index_dir",
             "we_derivative", "sn_derivative", "slope", "aspect")
COSMO_VARS = ("U_10M", "V_10M")
DERIVED_VARS = ("e_plus", "e_minus", "w_speed", "w_angle")


def compute_time_varying_topo_pred(u, v, slope, aspect):
    """Wind-terrain exposure e+/e- (reference data_processing.py:68-73):
    the signed sine of the flow-aligned terrain inclination."""
    delta = np.arctan2(-v, -u) - aspect
    alpha = np.arctan(np.tan(slope) * np.cos(delta))
    sin_a = np.sin(alpha)
    return np.where(sin_a > 0, sin_a, 0.0), np.where(sin_a < 0, sin_a, 0.0)


def compute_wind_speed_and_angle(u, v):
    return np.sqrt(u**2 + v**2), np.arctan2(v, u)


def _cosmo_grid(cosmo: Dataset):
    """COSMO files carry 2-D lat_1/lon_1; approximate each with its 1-D
    axis medians for nearest-sampling (the grids are near-regular)."""
    lat = cosmo.coords["lat_1"].values
    lon = cosmo.coords["lon_1"].values
    if lat.ndim == 2:
        lat1d = np.median(lat, axis=1)
        lon1d = np.median(lon, axis=0)
    else:
        lat1d, lon1d = lat, lon
    return lat1d, lon1d


def _sample_topo(topo: Dataset, lat1d, lon1d) -> Dataset:
    return topo.sel_nearest(x=lon1d, y=lat1d)


def _derived(full: dict, u_name: str, v_name: str):
    e_plus, e_minus = compute_time_varying_topo_pred(
        full[u_name], full[v_name], full["slope"], full["aspect"])
    w_speed, w_angle = compute_wind_speed_and_angle(
        full[u_name], full[v_name])
    return {"e_plus": e_plus, "e_minus": e_minus,
            "w_speed": w_speed, "w_angle": w_angle}


def _day_str(d) -> str:
    return pd.Timestamp(d).strftime("%Y%m%d")


def _already_processed(x_path, required) -> bool:
    if not os.path.isfile(x_path):
        return False
    try:
        ds = open_mfdataset(str(x_path))
    except Exception:
        return False
    return set(required) <= set(ds.data_vars)


def process_imgs(
    path_to_processed_files: str,
    ERA5_data_path: str,
    COSMO1_data_path: str,
    DEM_data_path: str,
    start_date,
    end_date,
    surface_variables_included: Tuple[str, ...] = SURFACE_VARS,
    z500_variables_included: Tuple[str, ...] = Z500_VARS,
    topo_variables_included: Tuple[str, ...] = TOPO_VARS,
    cosmo_variables_included: Tuple[str, ...] = COSMO_VARS,
    homemade_variables_included: Tuple[str, ...] = DERIVED_VARS,
):
    processed = pathlib.Path(path_to_processed_files)
    processed.mkdir(parents=True, exist_ok=True)
    print("Reading DEM descriptor files")
    topo = open_mfdataset(str(pathlib.Path(DEM_data_path) / "topo_*.nc"))
    required = set(surface_variables_included) | set(
        z500_variables_included) | set(topo_variables_included)

    for d in pd.date_range(start_date, end_date):
        d_str = _day_str(d)
        x_path = processed / f"x_{d_str}.nc"
        y_path = processed / f"y_{d_str}.nc"
        if _already_processed(x_path, required):
            print(f"Inputs and outputs for date {d_str} already processed.")
            continue
        print(f"Processing {d_str}")
        cosmo = open_mfdataset(
            str(pathlib.Path(COSMO1_data_path) / f"*{d_str}*.nc"))
        lat1d, lon1d = _cosmo_grid(cosmo)
        nt = cosmo.sizes["time"]
        time_vals = cosmo.coords["time"].values

        surface = open_mfdataset(
            str(pathlib.Path(ERA5_data_path) / f"{d_str}*surface*.nc"))
        surface = surface[list(surface_variables_included)].sel_nearest(
            longitude=lon1d, latitude=lat1d)
        z500 = open_mfdataset(
            str(pathlib.Path(ERA5_data_path) / f"{d_str}*z500*.nc"))
        z500 = z500[list(z500_variables_included)].sel_nearest(
            longitude=lon1d, latitude=lat1d)

        topo_s = _sample_topo(topo, lat1d, lon1d)

        arrays = {}
        for v in surface_variables_included:
            arrays[v] = np.asarray(surface[v].values, np.float32)
        for v in z500_variables_included:
            arrays[v] = np.asarray(z500[v].values, np.float32)
        for v in topo_variables_included:
            if v in topo_s:
                static = np.asarray(topo_s[v].values, np.float32)
                arrays[v] = np.broadcast_to(static, (nt,) + static.shape)
        if "e_plus" in homemade_variables_included and \
                "slope" in arrays and "u10" in arrays:
            derived = _derived(arrays, "u10", "v10")
            for k in homemade_variables_included:
                arrays[k] = derived[k].astype(np.float32)

        coords = {
            "time": DataArray(("time",), time_vals),
            "y_1": DataArray(("y_1",), lat1d),
            "x_1": DataArray(("x_1",), lon1d),
        }
        x_ds = Dataset(
            {k: DataArray(("time", "y_1", "x_1"), v)
             for k, v in arrays.items()},
            coords)
        x_ds.to_netcdf(x_path)
        if not y_path.exists():
            y_ds = Dataset(
                {v: DataArray(("time", "y_1", "x_1"),
                              np.asarray(cosmo[v].values, np.float32))
                 for v in cosmo_variables_included},
                coords)
            y_ds.to_netcdf(y_path)
        print(f"wrote {x_path} / {y_path}")


def process_imgs_cosmoblurred(
    path_to_processed_files: str,
    COSMO1_data_path: str,
    DEM_data_path: str,
    start_date,
    end_date,
    topo_variables_included: Tuple[str, ...] = TOPO_VARS,
    cosmo_variables_included: Tuple[str, ...] = COSMO_VARS,
    homemade_variables_included: Tuple[str, ...] = DERIVED_VARS,
    blurring: float = 7.0,
):
    """Self-downscaling variant (data_processing.py:153-211): inputs are
    Gaussian-blurred COSMO fields instead of ERA5."""
    from scipy.ndimage import gaussian_filter

    processed = pathlib.Path(path_to_processed_files)
    processed.mkdir(parents=True, exist_ok=True)
    topo = open_mfdataset(str(pathlib.Path(DEM_data_path) / "topo_*.nc"))
    required = set(cosmo_variables_included) | set(topo_variables_included)

    for d in pd.date_range(start_date, end_date):
        d_str = _day_str(d)
        x_path = processed / f"x_cosmo_{d_str}.nc"
        y_path = processed / f"y_{d_str}.nc"
        if _already_processed(x_path, required):
            print(f"Inputs and outputs for date {d_str} already processed.")
            continue
        cosmo = open_mfdataset(
            str(pathlib.Path(COSMO1_data_path) / f"*{d_str}*.nc"))
        lat1d, lon1d = _cosmo_grid(cosmo)
        nt = cosmo.sizes["time"]
        time_vals = cosmo.coords["time"].values
        topo_s = _sample_topo(topo, lat1d, lon1d)

        arrays = {}
        for v in cosmo_variables_included:
            raw = np.asarray(cosmo[v].values, np.float32)
            arrays[v] = np.stack(
                [gaussian_filter(raw[t], sigma=blurring)
                 for t in range(raw.shape[0])])
        for v in topo_variables_included:
            if v in topo_s:
                static = np.asarray(topo_s[v].values, np.float32)
                arrays[v] = np.broadcast_to(static, (nt,) + static.shape)
        if "e_plus" in homemade_variables_included and "slope" in arrays:
            derived = _derived(arrays, "U_10M", "V_10M")
            for k in homemade_variables_included:
                arrays[k] = derived[k].astype(np.float32)

        coords = {
            "time": DataArray(("time",), time_vals),
            "y_1": DataArray(("y_1",), lat1d),
            "x_1": DataArray(("x_1",), lon1d),
        }
        Dataset({k: DataArray(("time", "y_1", "x_1"), v)
                 for k, v in arrays.items()}, coords).to_netcdf(x_path)
        if not y_path.exists():
            Dataset({v: DataArray(("time", "y_1", "x_1"),
                                  np.asarray(cosmo[v].values, np.float32))
                     for v in cosmo_variables_included},
                    coords).to_netcdf(y_path)
        print(f"wrote {x_path} / {y_path}")
