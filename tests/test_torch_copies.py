"""The port's copies of the JAX package's pure-numpy modules stay equal to
their originals: tiling (bit for bit), the high-res template and regridding,
the NetCDF / GeoTIFF I/O (files written by one side read by the other),
the numpy metric oracles, the streaming engine's host helpers, the data
providers (decoders and the batch pipeline: tests/test_torch_data.py) and
the plots (their figures: tests/test_torch_viz.py)."""

import dataclasses
import itertools
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from windtpu.infer import template as jtemplate
from windtpu.infer import tiling as jtiling
from windtpu.io import dataset as jds
from windtpu.io import geotiff as jgeo
from windtpu.data import providers as jproviders
from windtpu.infer import streaming as jstreaming
from windtpu.metrics import oracles as joracles
from windtpu_torch.infer import template as ttemplate
from windtpu_torch.infer import tiling as ttiling
from windtpu_torch.io import dataset as tds
from windtpu_torch.io import geotiff as tgeo
from windtpu_torch.data import providers as tproviders
from windtpu_torch.infer import engine as tengine
from windtpu_torch.infer import streaming as tstreaming
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


def test_host_copies_equal_their_originals():
    """_clamped_start, _host_patch and _host_stats are copies of the JAX
    package's numpy helpers."""
    rng = np.random.RandomState(2)
    field = rng.standard_normal((7, 41, 53, 3)).astype(np.float32)
    field[1, 4:9, 2:6, 1] = np.nan
    for start, size, dim in [(-3, 4, 10), (0, 4, 10), (8, 4, 10),
                             (17, 32, 48)]:
        assert tstreaming._clamped_start(start, size, dim) == \
            jstreaming._clamped_start(start, size, dim)
    for origin in [(0, 0, 0), (21, 9, 1), (30, 20, 1)]:
        np.testing.assert_array_equal(
            tstreaming._host_patch(field, origin, 4, 32),
            jstreaming._host_patch(field, origin, 4, 32))
    plan = ttiling.TilingPlan(image_size=32, sequence_length=4,
                              pixels_lat=41, pixels_lon=53, time_window=7,
                              starts_x=(0, 21), starts_y=(0, 9),
                              num_time_chunks=2)
    origins, weights = tengine._grouped_origins(plan, 3)
    for quirk in (True, False):
        got = tstreaming._host_stats(field, origins, weights, 4, 32, quirk)
        want = jstreaming._host_stats(field, origins, weights, 4, 32, quirk)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_provider_patterns_and_dates_equal(tmp_path):
    for pattern in ("x_{date}.nc", "{date:d}_era5.nc", "d/{date}_{x}.nc"):
        for name in ("x_20200101.nc", "20200101_era5.nc", "d/0101_a.nc",
                     "y_20200101.nc"):
            j = jproviders._pattern_to_regex(pattern).match(name)
            t = tproviders._pattern_to_regex(pattern).match(name)
            assert (t and t.group("date")) == (j and j.group("date"))
    assert tproviders._substitute_date("x_{date}.nc", "0101") == \
        jproviders._substitute_date("x_{date}.nc", "0101") == "x_0101.nc"
    with pytest.raises(ValueError):
        tproviders._substitute_date("x_{date}.nc", "..")
    for d in ("20200101", "0102"):
        (tmp_path / f"x_{d}.nc").touch()
    (tmp_path / "notes.txt").touch()
    got = tproviders.LocalFileProvider(tmp_path, "x_{date}.nc")
    want = jproviders.LocalFileProvider(tmp_path, "x_{date}.nc")
    assert got.available_dates == want.available_dates == {"20200101",
                                                           "0102"}
    assert got.load("0102") == want.load("0102")
    with pytest.raises(ValueError):
        tproviders.LocalFileProvider(tmp_path, "static.nc")


@pytest.mark.parametrize("store", ["GCSFileProvider", "S3FileProvider"])
def test_object_store_providers_on_a_mocked_transport(tmp_path, monkeypatch,
                                                      store):
    """Both packages' object-store providers against a fake ``gsutil`` /
    ``s3cmd`` on PATH that serves a directory tree as the bucket."""
    scheme = "gs" if store.startswith("GCS") else "s3"
    bucket = tmp_path / "bucket" / "days"
    bucket.mkdir(parents=True)
    for d in ("20200101", "20200102"):
        (bucket / f"x_{d}.nc").write_text(d)
    (bucket / "README").touch()
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for tool, ls, fetch in (("gsutil", "ls", "cp"), ("s3cmd", "ls", "get")):
        fake = bin_dir / tool
        fake.write_text(f"""#!/bin/sh
root={tmp_path}
cmd=$1; shift
case "$cmd" in
  {ls}) for f in "$root/${{1#{scheme}://}}"*; do echo "{scheme}://${{f#$root/}}"; done ;;
  {fetch}) src="$root/${{1#{scheme}://}}"; cp "$src" "$2" ;;
  *) exit 64 ;;
esac
""")
        fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    for mod in (jproviders, tproviders):
        p = getattr(mod, store)(f"{scheme}://bucket", "days",
                                pattern="x_{date}.nc")
        assert p.available_dates == {"20200101", "20200102"}
        with p.provide("20200101") as path:
            got = Path(path)
            assert got.read_text() == "20200101"
        assert not got.exists() and not got.parent.exists()
    monkeypatch.setenv("PATH", str(tmp_path))     # no tool at all
    with pytest.raises(RuntimeError, match="not runnable"):
        getattr(tproviders, store)("bucket", pattern="x_{date}.nc"
                                   ).available_dates


@pytest.mark.parametrize("name", ["assets", "preprocess.daily",
                                  "preprocess.download_era5",
                                  "preprocess.download_cosmo", "viz"])
def test_module_copies_equal_their_originals_in_code(name):
    """The port's copies of these pure-Python modules differ from their
    originals in the module docstring and the package name only."""
    import ast

    def code(path, package):
        tree = ast.parse(Path(path).read_text())
        if ast.get_docstring(tree) is not None:
            tree.body = tree.body[1:]
        return ast.unparse(tree).replace(package, "PACKAGE")

    root = Path(__file__).resolve().parents[1]
    stem = name.replace(".", "/")
    original = root / "windtpu" / (
        "assets/__init__.py" if name == "assets" else f"{stem}.py")
    copy = root / "windtpu_torch" / f"{stem}.py"
    assert code(copy, "windtpu_torch") == code(original, "windtpu")


def test_swiss_cosmo_grid_equal():
    from windtpu.assets import swiss_cosmo_grid as jgrid
    from windtpu_torch.assets import swiss_cosmo_grid as tgrid

    _assert_datasets_equal(tgrid(), jgrid())


def test_netcdf3_written_without_h5py_reads_back_in_both_packages(
        tmp_path, monkeypatch):
    """Where h5py is missing, the port's Dataset.to_netcdf writes NetCDF-3
    through scipy; both packages' readers give back the values, the
    dimension coordinates and the times, the port's reader also a 2-D
    coordinate and native-endian arrays."""
    era5 = _era5(tds)
    era5["band"] = tds.DataArray(("longitude",), np.arange(7))
    monkeypatch.setitem(sys.modules, "h5py", None)   # import h5py fails
    era5.to_netcdf(tmp_path / "era5.nc")
    assert (tmp_path / "era5.nc").read_bytes()[:4] == b"CDF\x02"
    for mod in (tds, jds):
        _assert_datasets_equal(mod.open_dataset(tmp_path / "era5.nc"), era5)
    era5.coords["lat_2d"] = tds.DataArray(
        ("latitude", "longitude"), np.arange(42.0).reshape(6, 7))
    era5.to_netcdf(tmp_path / "era5_2d.nc")
    got = tds.open_dataset(tmp_path / "era5_2d.nc")
    _assert_datasets_equal(got, era5)
    assert all(got[n].values.dtype.isnative
               for n in list(got.data_vars) + list(got.coords))


def test_free_tcp_port_copy_equals_its_original():
    """``windtpu_torch.utils.hostcpu.free_tcp_port`` is the JAX package's,
    but for its docstring; both hand out a port that can be bound."""
    import ast
    import inspect
    import socket

    from windtpu.utils import hostcpu as jhostcpu
    from windtpu_torch.utils import hostcpu as thostcpu

    def body(fn):
        tree = ast.parse(inspect.getsource(fn)).body[0]
        tree.body = tree.body[1:]          # the docstring
        return ast.dump(tree)

    assert body(thostcpu.free_tcp_port) == body(jhostcpu.free_tcp_port)
    for fn in (thostcpu.free_tcp_port, jhostcpu.free_tcp_port):
        with socket.socket() as s:
            s.bind(("127.0.0.1", fn()))
