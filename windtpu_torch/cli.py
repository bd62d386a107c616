"""Console entry point ``downscale`` of the port.

Same contract as ``windtpu/cli.py:main`` (``--era --dem --date --lon --lat
-o``: reads ``{date}*surface*.nc`` ERA5 files and a GeoTIFF DEM, writes a
NetCDF of downscaled u10/v10), plus ``--device`` (default: the card).
Run as ``python -m windtpu_torch.cli``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Downscale ERA5 wind fields to ~1 km")
    parser.add_argument("--era", required=True,
                        help="path to folder with ERA5 data")
    parser.add_argument("--dem", required=True, help="path to DEM data file")
    parser.add_argument("--date", required=True,
                        help="date to downscale in YYYYMMDD format")
    parser.add_argument("--lon", default=None,
                        help="longitude range (ex: 45.6:46.2)")
    parser.add_argument("--lat", default=None,
                        help="latitude range (ex: 45.6:46.2)")
    parser.add_argument("-o", "--output", default="downscaled.nc",
                        help="output path for the downscaled map (*.nc)")
    parser.add_argument("--weights", default=None,
                        help=".npz generator weights")
    parser.add_argument("--ensemble", type=int, default=1,
                        help="number of stochastic ensemble members")
    parser.add_argument("--overlap-factor", type=float, default=0.01)
    parser.add_argument("--no-texture-gate", action="store_true",
                        help="disable the flow-conditional texture gate "
                             "(raw generator output)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    args = parser.parse_args(argv)

    from windtpu_torch import api
    from windtpu_torch.core.device import resolve_device
    from windtpu_torch.io.dataset import open_mfdataset
    from windtpu_torch.io.geotiff import open_rasterio

    device = resolve_device(args.device)  # fail before reading any input

    longitude_r = tuple(map(float, args.lon.split(":"))) if args.lon else None
    latitude_r = tuple(map(float, args.lat.split(":"))) if args.lat else None

    era5 = open_mfdataset(str(Path(args.era) / f"{args.date}*surface*.nc"))
    raster = open_rasterio(args.dem)
    network = api.get_network(args.weights, device=device)
    result = api.downscale(
        era5, raster, range_lon=longitude_r, range_lat=latitude_r,
        overlap_factor=args.overlap_factor, network=network,
        ensemble_members=args.ensemble, device=device,
        texture_gate=False if args.no_texture_gate else "auto")
    result.to_netcdf(args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
