"""DEM -> topographic descriptor files (counterpart of
``windtpu/preprocess/topo.py``).

Reads the DEM GeoTIFF, computes elevation, tpi_500, we/sn derivatives,
slope, aspect and the ridge index pair with the stencils of
:mod:`windtpu_torch.ops.stencil` on ``device``, and writes each as
``topo_<name>.nc`` next to the DEM; a DEM whose eight files all exist is
skipped.
"""

from __future__ import annotations

import pathlib

from windtpu_torch.io.dataset import DataArray, Dataset
from windtpu_torch.io.geotiff import open_rasterio
from windtpu_torch.ops.stencil import topographic_descriptors

NAMES = ("elevation", "tpi_500", "we_derivative", "sn_derivative",
         "slope", "aspect", "ridge_index_norm", "ridge_index_dir")


def process_topographic_variables_file(path_to_file: str,
                                       scale_meters: float = 500.0,
                                       device=None):
    """Write the eight ``topo_<name>.nc`` beside ``path_to_file``; the
    stencils run on ``device`` (``None`` means the card)."""
    path = pathlib.Path(path_to_file)
    if all((path.parent / f"topo_{n}.nc").exists() for n in NAMES):
        print("Already processed all topo files")
        return
    raster = open_rasterio(path)
    dem = raster["band_data"].values[0]
    y = raster.coords["y"].values
    x = raster.coords["x"].values
    descriptors = topographic_descriptors(dem, y, x, scale_meters,
                                          device=device)
    for name in NAMES:
        vals = descriptors[name].cpu().numpy()
        ds = Dataset(
            {name: DataArray(("y", "x"), vals)},
            {"y": DataArray(("y",), y), "x": DataArray(("x",), x)},
        )
        out = path.parent / f"topo_{name}.nc"
        ds.to_netcdf(out)
        print(f"wrote {out}")
