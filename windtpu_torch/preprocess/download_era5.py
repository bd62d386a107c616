"""ERA5 downloader via the Copernicus CDS API.

A copy of ``windtpu/preprocess/download_era5.py`` (pandas; ``cdsapi``
imported late), kept so the port imports nothing of the JAX package;
tests/test_torch_copies.py pins it to the original.

Same acquisition contract as the reference (download_ERA5.py:8-54): per-day
NetCDF files of 24 hourly steps, one surface set and one 500-hPa set, with
skip-if-exists resumability.  Requires the optional ``cdsapi`` package and
``~/.cdsapirc`` credentials; import is deferred so the rest of the
framework works without network tooling.
"""

from __future__ import annotations

from datetime import date
from pathlib import Path

import pandas as pd

HOURS = [f"{h:02d}:00" for h in range(24)]

SURFACE_VARIABLES = [
    "100m_u_component_of_wind", "100m_v_component_of_wind",
    "10m_u_component_of_wind", "10m_v_component_of_wind",
    "2m_dewpoint_temperature", "2m_temperature",
    "boundary_layer_height", "surface_pressure",
    "surface_sensible_heat_flux", "total_precipitation",
    "forecast_surface_roughness",
]

Z500_VARIABLES = ["divergence", "geopotential", "vertical_velocity",
                  "vorticity"]


def _download(datapath, file_suffix, start_date, end_date, area, data_name,
              extra_args):
    import cdsapi  # optional dependency

    client = cdsapi.Client()
    base = {
        "product_type": "reanalysis",
        "format": "netcdf",
        "time": HOURS,
        "area": list(area),
        **extra_args,
    }
    for day in pd.date_range(start_date, end_date):
        filename = f"{day.year}{day.month:02d}{day.day:02d}_{file_suffix}"
        dest = Path(datapath).joinpath(filename).with_suffix(".nc")
        if dest.exists():
            print(f"File {filename} already exists")
            continue
        dest.parent.mkdir(parents=True, exist_ok=True)
        request = {**base, "year": day.year, "month": day.month,
                   "day": day.day}
        client.retrieve(data_name, request, str(dest))


def download_ERA5_surface(datapath, start_date, end_date, area):
    _download(datapath, "era5_surface_hourly", start_date, end_date, area,
              "reanalysis-era5-single-levels",
              {"variable": SURFACE_VARIABLES})


def download_ERA5_pressure_500(datapath, start_date, end_date, area):
    _download(datapath, "era5_z500_hourly", start_date, end_date, area,
              "reanalysis-era5-pressure-levels",
              {"pressure_level": "500", "variable": Z500_VARIABLES})


def download_ERA5(datapath, start_date=date(2016, 1, 10),
                  end_date=date(2020, 12, 31),
                  latitude_range=(45.4, 48.2),
                  longitude_range=(5.2, 11.02)):
    """Default bbox/date range match the Swiss training domain
    (download_ERA5.py:51-52)."""
    area = (latitude_range[1], longitude_range[0], latitude_range[0],
            longitude_range[1])
    download_ERA5_surface(datapath, start_date, end_date, area)
    download_ERA5_pressure_500(datapath, start_date, end_date, area)
