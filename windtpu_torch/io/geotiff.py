"""Minimal GeoTIFF reader (DEM rasters) built on PIL.

A copy of ``windtpu/io/geotiff.py`` (pure numpy + PIL), kept so the port
imports nothing of the JAX package; tests/test_torch_copies.py pins it to
the original.

Replaces the reference's ``xr.open_rasterio`` (cli.py:23,
data_processing.py:49) for the one thing the pipeline does with it: read a
single-band elevation raster with its geographic x/y coordinates.

Georeferencing is taken from the standard GeoTIFF tags:
ModelPixelScaleTag (33550) and ModelTiepointTag (33922), or
ModelTransformationTag (34264).  Coordinates follow the rasterio/xarray
convention of pixel-center x (lon) / y (lat) arrays.
"""

from __future__ import annotations

import numpy as np

from windtpu_torch.io.dataset import DataArray, Dataset

_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_MODEL_TRANSFORM = 34264
# GDAL's nodata sidecar tag (ASCII) — real SRTM tiles mark voids with it
# (value -32768 in int16 tiles); those must surface as NaN, not elevation.
_GDAL_NODATA = 42113


def open_rasterio(path) -> Dataset:
    """Read a GeoTIFF into a Dataset with dims (band, y, x)."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as img:
        frames = []
        try:
            i = 0
            while True:
                img.seek(i)
                frames.append(np.asarray(img))
                i += 1
        except EOFError:
            pass
        tags = dict(getattr(img, "tag_v2", {}) or {})

    data = np.stack(frames, axis=0)  # (band, y, x)
    if data.ndim == 4:  # multi-sample (y, x, c) frames
        data = np.moveaxis(data[0], -1, 0)
    nb, ny, nx = data.shape

    data = data.astype(np.float32)
    nodata = tags.get(_GDAL_NODATA)
    if nodata is not None:
        try:
            nd = float(str(nodata).strip().strip("\x00"))
        except ValueError:
            nd = None
        if nd is not None:
            data = np.where(data == np.float32(nd), np.nan, data)

    if _MODEL_TRANSFORM in tags:
        m = np.asarray(tags[_MODEL_TRANSFORM], dtype=np.float64).reshape(4, 4)
        x0, dx = m[0, 3], m[0, 0]
        y0, dy = m[1, 3], m[1, 1]
    elif _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        tie = tags[_MODEL_TIEPOINT]
        # tie: (i, j, k, X, Y, Z) raster->model anchor
        x0 = tie[3] - tie[0] * sx
        y0 = tie[4] + tie[1] * sy
        dx, dy = sx, -sy
    else:
        x0, dx, y0, dy = 0.0, 1.0, float(ny), -1.0

    x = x0 + dx * (np.arange(nx) + 0.5)
    y = y0 + dy * (np.arange(ny) + 0.5)

    return Dataset(
        {"band_data": DataArray(("band", "y", "x"), data)},
        {
            "band": DataArray(("band",), np.arange(1, nb + 1)),
            "y": DataArray(("y",), y),
            "x": DataArray(("x",), x),
        },
    )


def write_geotiff_like(path, data: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Write a single-band float GeoTIFF with georeferencing tags (testing
    helper — lets the test suite fabricate DEM inputs without rasterio)."""
    from PIL import Image, TiffImagePlugin

    dx = float(x[1] - x[0]) if len(x) > 1 else 1.0
    dy = float(y[0] - y[1]) if len(y) > 1 else 1.0
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[_MODEL_PIXEL_SCALE] = (dx, abs(dy), 0.0)
    # Anchor pixel (0,0) corner at (x0 - dx/2, y0 + |dy|/2).
    info[_MODEL_TIEPOINT] = (0.0, 0.0, 0.0,
                             float(x[0]) - dx / 2,
                             float(y[0]) + abs(dy) / 2, 0.0)
    im = Image.fromarray(np.asarray(data, dtype=np.float32))
    im.save(path, tiffinfo=info)
