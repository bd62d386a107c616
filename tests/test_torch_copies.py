"""The port's copies of the JAX package's pure-numpy modules stay equal to
their originals: tiling (bit for bit), the high-res template and regridding,
the NetCDF / GeoTIFF I/O (files written by one side read by the other),
and the numpy metric oracles."""

import dataclasses
import itertools

import numpy as np
import pytest

from windtpu.infer import template as jtemplate
from windtpu.infer import tiling as jtiling
from windtpu.io import dataset as jds
from windtpu.io import geotiff as jgeo
from windtpu.metrics import oracles as joracles
from windtpu_torch.infer import template as ttemplate
from windtpu_torch.infer import tiling as ttiling
from windtpu_torch.io import dataset as tds
from windtpu_torch.io import geotiff as tgeo
from windtpu_torch.metrics import oracles as toracles


@pytest.mark.parametrize("h,w", [(96, 96), (97, 203), (546, 756),
                                 (1000, 131)])
def test_plan_tiling_and_origins_equal(h, w):
    for t, overlap, (img, seq) in itertools.product(
            (24, 30, 49), (0.0, 0.01, 0.05, 0.3, 1.0), ((96, 24), (32, 6))):
        if h < img or w < img or t < seq:
            continue
        jplan = jtiling.plan_tiling(h, w, t, img, seq, overlap)
        tplan = ttiling.plan_tiling(h, w, t, img, seq, overlap)
        assert dataclasses.astuple(tplan) == dataclasses.astuple(jplan)
        np.testing.assert_array_equal(tplan.patch_origins(),
                                      jplan.patch_origins())


def _era5(mod, seed=0, nt=5, nlat=6, nlon=7):
    rng = np.random.RandomState(seed)
    dims = ("time", "latitude", "longitude")
    return mod.Dataset(
        {"u10": mod.DataArray(dims, rng.standard_normal(
            (nt, nlat, nlon)).astype(np.float32)),
         "v10": mod.DataArray(dims, rng.standard_normal(
             (nt, nlat, nlon)).astype(np.float32))},
        {"time": mod.DataArray(("time",), np.arange(
            "2016-04-01T00", "2016-04-01T05", dtype="datetime64[h]")),
         "latitude": mod.DataArray(("latitude",), np.linspace(46, 45, nlat)),
         "longitude": mod.DataArray(("longitude",), np.linspace(6, 7.5,
                                                                nlon))})


def _dem(mod, seed=1):
    rng = np.random.RandomState(seed)
    x = np.linspace(5.9, 7.6, 70)
    y = np.linspace(46.1, 44.9, 50)
    return mod.Dataset(
        {"band_data": mod.DataArray(("band", "y", "x"), rng.standard_normal(
            (1, 50, 70)).astype(np.float32))},
        {"band": mod.DataArray(("band",), np.array([1])),
         "y": mod.DataArray(("y",), y), "x": mod.DataArray(("x",), x)})


def _assert_datasets_equal(a, b):
    assert sorted(a.data_vars) == sorted(b.data_vars)
    assert sorted(a.coords) == sorted(b.coords)
    for name in list(a.data_vars) + list(a.coords):
        assert a[name].dims == b[name].dims, name
        np.testing.assert_array_equal(a[name].values, b[name].values)


@pytest.mark.parametrize("bbox", [None, ((6.2, 7.1), (45.2, 45.9))])
def test_template_and_regridding_equal(bbox):
    lon, lat = bbox or (None, None)
    jt = jtemplate.build_high_res_template_from_era5(
        _era5(jds), range_lon=lon, range_lat=lat)
    tt = ttemplate.build_high_res_template_from_era5(
        _era5(tds), range_lon=lon, range_lat=lat)
    _assert_datasets_equal(tt, jt)
    _assert_datasets_equal(ttemplate.process_era5(_era5(tds), tt),
                           jtemplate.process_era5(_era5(jds), jt))
    _assert_datasets_equal(ttemplate.process_topo(_dem(tds), tt),
                           jtemplate.process_topo(_dem(jds), jt))


def test_netcdf_and_geotiff_round_trip_across_packages(tmp_path):
    _era5(jds).to_netcdf(tmp_path / "j_era5_surface.nc")
    _era5(tds, seed=2).to_netcdf(tmp_path / "t_era5_surface.nc")
    for name in ("j_era5_surface.nc", "t_era5_surface.nc"):
        _assert_datasets_equal(tds.open_dataset(tmp_path / name),
                               jds.open_dataset(tmp_path / name))
    _assert_datasets_equal(
        tds.open_mfdataset(str(tmp_path / "*surface*.nc")),
        jds.open_mfdataset(str(tmp_path / "*surface*.nc")))
    dem = np.random.RandomState(3).standard_normal((20, 30)).astype(
        np.float32)
    x, y = np.linspace(6, 7, 30), np.linspace(46, 45, 20)
    jgeo.write_geotiff_like(tmp_path / "j.tif", dem, x, y)
    tgeo.write_geotiff_like(tmp_path / "t.tif", dem, x, y)
    for name in ("j.tif", "t.tif"):
        _assert_datasets_equal(tgeo.open_rasterio(tmp_path / name),
                               jgeo.open_rasterio(tmp_path / name))


ORACLES = ["wind_speed_weighted_rmse_np", "extreme_weighted_rmse_np",
           "wind_speed_rmse_np", "angular_cosine_distance_np",
           "log_spectral_distance_np", "log_spectral_distance_fullfft_np",
           "rmse_np", "tanh_wind_speed_weighted_rmse_np",
           "cosine_similarity_np", "spatial_ks_bruteforce_np"]


def test_oracles_module_has_the_same_functions():
    public = lambda mod: sorted(  # noqa: E731
        n for n in dir(mod) if n.endswith("_np") and not n.startswith("_"))
    assert public(toracles) == public(joracles) == sorted(ORACLES)
    assert toracles.EPSILON == joracles.EPSILON


@pytest.mark.parametrize("name", ORACLES)
def test_metric_oracles_equal(name):
    rng = np.random.RandomState(ORACLES.index(name))
    shape = (1, 2, 9, 8, 2) if name.startswith("spatial_ks") else (
        2, 3, 6, 7, 2)
    real = (4 * rng.standard_normal(shape)).astype(np.float32)
    fake = (4 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("tanh_wind_speed_weighted_rmse_np", "cosine_similarity_np"):
        args = ((real[..., 0], real[..., 1]), (fake[..., 0], fake[..., 1]))
        kw = {}
    elif name.startswith("spatial_ks"):
        args, kw = (real, fake), dict(patch_size=3, num_points=11)
    else:
        args, kw = (real, fake), {}
    np.testing.assert_array_equal(getattr(toracles, name)(*args, **kw),
                                  getattr(joracles, name)(*args, **kw))
