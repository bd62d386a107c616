"""High-res template construction and nearest-neighbour regridding.

A copy of ``windtpu/infer/template.py``; tests/test_torch_copies.py pins it
to the original.

Host-side grid math mirroring the reference's inference preprocessing
(api.py:31-62): build the ~1-km target grid by upsampling the ERA5 bbox
lat x26 / lon x18 with np.linspace, then nearest-sample ERA5 winds and the
DEM onto it.  Operates on :class:`windtpu_torch.io.Dataset` instead of
xarray.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from windtpu_torch.io.dataset import DataArray, Dataset

UPSAMPLING_LAT = 26
UPSAMPLING_LON = 18


def build_high_res_template_from_era5(
    ds_era5: Dataset,
    range_lon: Optional[Tuple[float, float]] = None,
    range_lat: Optional[Tuple[float, float]] = None,
) -> Dataset:
    """Target grid spec: coords ``lon_1``/``lat_1`` linspaced over the bbox
    at 18x/26x the ERA5 resolution (api.py:46-62)."""
    if range_lon:
        ds_era5 = ds_era5.sel_range(longitude=(range_lon[0], range_lon[1]))
    else:
        lons = ds_era5.coords["longitude"].values
        range_lon = (float(lons.min()), float(lons.max()))
    if range_lat:
        ds_era5 = ds_era5.sel_range(latitude=(range_lat[0], range_lat[1]))
    else:
        lats = ds_era5.coords["latitude"].values
        range_lat = (float(lats.min()), float(lats.max()))
    nb_lon = ds_era5.sizes["longitude"]
    nb_lat = ds_era5.sizes["latitude"]
    new_lon = np.linspace(range_lon[0], range_lon[1], UPSAMPLING_LON * nb_lon)
    new_lat = np.linspace(range_lat[0], range_lat[1], UPSAMPLING_LAT * nb_lat)
    coords = {
        "lon_1": DataArray(("lon_1",), new_lon),
        "lat_1": DataArray(("lat_1",), new_lat),
    }
    if "time" in ds_era5.coords:
        coords["time"] = ds_era5.coords["time"]
    return Dataset({}, coords)


def process_era5(ds_era5: Dataset, template: Dataset) -> Dataset:
    """Nearest-sample u10/v10 onto the template grid (api.py:40-43)."""
    lon = template.coords["lon_1"].values
    lat = template.coords["lat_1"].values
    out = ds_era5[["u10", "v10"]].sel_nearest(longitude=lon, latitude=lat)
    return out.rename({"longitude": "lon_1", "latitude": "lat_1"})


def process_topo(raster: Dataset, template: Dataset) -> Dataset:
    """Nearest-sample DEM band 0 onto the template grid as ``elevation``
    (api.py:31-37)."""
    lon = template.coords["lon_1"].values
    lat = template.coords["lat_1"].values
    dem = raster.isel(band=0)
    dem = Dataset({"elevation": dem["band_data"]}, dem.coords)
    out = dem.sel_nearest(x=lon, y=lat)
    return out.rename({"x": "lon_1", "y": "lat_1"})
