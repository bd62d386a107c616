"""The port's preprocessing (windtpu_torch/preprocess, cli.prepare_main)
against windtpu's on fabricated inputs: the topo job's eight descriptor
files, the daily x/y builders (plain and COSMO-blurred), the prepare entry
point as a process, the downloaders on mocked transports, and prepared days
flowing into the port's data pipeline and into train_main with the
reconstruction loss.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_preprocess import _write_day_files
from tests.test_torch_stencil import _near_ties
from windtpu import cli as jcli
from windtpu.data import BatchGenerator as JBatchGenerator
from windtpu.data import LocalFileProvider as JLocalFileProvider
from windtpu.io import dataset as jds
from windtpu.io.geotiff import write_geotiff_like
from windtpu.preprocess import daily as jdaily
from windtpu.preprocess import download_cosmo as jcosmo
from windtpu.preprocess import download_era5 as jera5
from windtpu.preprocess import topo as jtopo
from windtpu_torch import cli as tcli
from windtpu_torch.core.config import DataConfig
from windtpu_torch.data import BatchGenerator, LocalFileProvider
from windtpu_torch.io import dataset as tds
from windtpu_torch.ops import stencil
from windtpu_torch.preprocess import daily as tdaily
from windtpu_torch.preprocess import download_cosmo as tcosmo
from windtpu_torch.preprocess import download_era5 as tera5
from windtpu_torch.preprocess import topo as ttopo

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DAY = "2020-01-01"


def _write_dem(path, ny=40, nx=60):
    """A random DEM (the JAX package's preprocessing test's) with a hole."""
    x = np.linspace(6.0, 9.0, nx)
    y = np.linspace(47.5, 45.5, ny)
    dem = np.random.RandomState(0).uniform(300, 2500, (ny, nx)).astype(
        np.float32)
    dem[10:14, 20:25] = np.nan
    path.parent.mkdir(parents=True, exist_ok=True)
    write_geotiff_like(path, dem, x, y)
    return path


def _assert_descriptors_close(got_dir, want_dir):
    """The eight topo files: equal coordinates; elevation, TPI and ridge
    norm within 1e-4 of the DEM's scale (one f32 step there is 1.2e-4 m),
    the rest within 1e-4; the ridge direction exactly off near-ties."""
    scale = None
    for name in jtopo.NAMES:
        got = tds.open_dataset(got_dir / f"topo_{name}.nc")
        want = jds.open_dataset(want_dir / f"topo_{name}.nc")
        for coord in ("y", "x"):
            np.testing.assert_array_equal(got[coord].values,
                                          want[coord].values)
        g, w = got[name].values, np.asarray(want[name].values)
        assert got[name].dims == ("y", "x") and not np.isnan(g).any()
        if name == "elevation":
            scale = float(np.abs(w).max())
            elevation = g
        if name == "ridge_index_dir":
            res = stencil.meters_per_pixel(got["y"].values, got["x"].values)
            px = max(int(round(500.0 / abs(res[1]))), 1)
            kernels = np.stack([stencil._line_kernel(px, t)
                                for t in np.arange(4) * np.pi / 4])
            e = torch.from_numpy(elevation)
            resp = torch.clamp(e[None] - stencil._masked_mean(e, kernels),
                               min=0.0).numpy()
            clear = ~_near_ties(resp)
            assert clear.mean() > 0.5
            np.testing.assert_array_equal(g[clear], w[clear])
            continue
        tol = 1e-4 * (scale if name in ("elevation", "tpi_500",
                                        "ridge_index_norm") else 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def _assert_files_equal(got_path, want_path):
    got, want = tds.open_dataset(got_path), jds.open_dataset(want_path)
    assert sorted(got.data_vars) == sorted(want.data_vars)
    assert sorted(got.coords) == sorted(want.coords)
    for name in list(want.data_vars) + list(want.coords):
        assert got[name].dims == want[name].dims, name
        np.testing.assert_array_equal(got[name].values, want[name].values,
                                      err_msg=name)


def test_topo_job_matches_jax_and_is_idempotent(tmp_path, capsys):
    jdem = _write_dem(tmp_path / "j" / "dem.tif")
    tdem = tmp_path / "t" / "dem.tif"
    tdem.parent.mkdir()
    shutil.copy(jdem, tdem)
    jtopo.process_topographic_variables_file(str(jdem))
    ttopo.process_topographic_variables_file(str(tdem), device="cpu")
    assert ttopo.NAMES == jtopo.NAMES
    _assert_descriptors_close(tdem.parent, jdem.parent)
    stamp = (tdem.parent / "topo_slope.nc").stat().st_mtime_ns
    capsys.readouterr()
    ttopo.process_topographic_variables_file(str(tdem), device="cpu")
    assert "Already processed" in capsys.readouterr().out
    assert (tdem.parent / "topo_slope.nc").stat().st_mtime_ns == stamp


@pytest.fixture(scope="module")
def raw_days(tmp_path_factory):
    """The JAX topo job's descriptor files and one fabricated day of ERA5
    and COSMO-1 files, which both packages' daily builders read."""
    root = tmp_path_factory.mktemp("raw")
    dem = _write_dem(root / "dem" / "dem.tif")
    jtopo.process_topographic_variables_file(str(dem))
    _write_day_files(root, ny=40, nx=44, nt=8)
    return root


@pytest.mark.parametrize("blurred", [False, True])
def test_daily_builders_write_the_files_jax_writes(raw_days, tmp_path,
                                                   blurred, capsys):
    """x/y files of both packages' builders from the same inputs hold the
    same values bit for bit; a second run skips the day."""
    def build(mod, out):
        if blurred:
            mod.process_imgs_cosmoblurred(
                str(out), str(raw_days / "cosmo"), str(raw_days / "dem"),
                DAY, DAY)
        else:
            mod.process_imgs(str(out), str(raw_days / "era5"),
                             str(raw_days / "cosmo"), str(raw_days / "dem"),
                             DAY, DAY)

    build(jdaily, tmp_path / "j")
    build(tdaily, tmp_path / "t")
    x_name = "x_cosmo_20200101.nc" if blurred else "x_20200101.nc"
    for name in (x_name, "y_20200101.nc"):
        _assert_files_equal(tmp_path / "t" / name, tmp_path / "j" / name)
    capsys.readouterr()
    build(tdaily, tmp_path / "t")
    assert "already processed" in capsys.readouterr().out


def test_prepare_main_as_a_process_matches_jax(tmp_path):
    """``python -m windtpu_torch.cli prepare topo|daily`` against the JAX
    package's prepare_main on the same DEM and days."""
    dirs = {}
    for side in ("j", "t"):
        root = tmp_path / side
        _write_dem(root / "dem" / "dem.tif")
        _write_day_files(root, ny=40, nx=44, nt=8)
        dirs[side] = root
    topo = ["topo", "--dem", str(dirs["j"] / "dem" / "dem.tif")]
    jcli.prepare_main(topo)

    def daily(root):
        return ["daily", "--processed", str(root / "out"), "--era5",
                str(root / "era5"), "--cosmo", str(root / "cosmo"),
                "--dem-dir", str(root / "dem"), "--start", DAY, "--end", DAY]

    jcli.prepare_main(daily(dirs["j"]))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for argv in ([*topo[:2], str(dirs["t"] / "dem" / "dem.tif"),
                  "--device", "cpu"], daily(dirs["t"])):
        proc = subprocess.run(
            [sys.executable, "-m", "windtpu_torch.cli", "prepare", *argv],
            capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "wrote" in proc.stdout
    _assert_descriptors_close(dirs["t"] / "dem", dirs["j"] / "dem")
    assert sorted(p.name for p in (dirs["t"] / "out").iterdir()) == \
        ["x_20200101.nc", "y_20200101.nc"]
    # The daily files match where the descriptors do: the same ERA5 and
    # COSMO values, topo within the limits above.
    _assert_files_equal(dirs["t"] / "out" / "y_20200101.nc",
                        dirs["j"] / "out" / "y_20200101.nc")
    x_t = tds.open_dataset(dirs["t"] / "out" / "x_20200101.nc")
    x_j = jds.open_dataset(dirs["j"] / "out" / "x_20200101.nc")
    assert sorted(x_t.data_vars) == sorted(x_j.data_vars)
    for var in ("u10", "v10", "blh", "fsr", "sp", "z", "vo", "d",
                "w_speed", "w_angle"):
        np.testing.assert_array_equal(x_t[var].values, x_j[var].values)


def test_prepared_days_flow_into_the_batch_generator_and_train_main(
        raw_days, tmp_path):
    """Days the port's prepare wrote give the port's BatchGenerator the
    batches the JAX package's gives, with every default input variable;
    train_main trains on them with the reconstruction loss on."""
    out = tmp_path / "out"
    tdaily.process_imgs(str(out), str(raw_days / "era5"),
                        str(raw_days / "cosmo"), str(raw_days / "dem"),
                        DAY, DAY)
    dcfg = DataConfig(batch_size=2, patch_size=24, sequence_length=2)
    for v in dcfg.input_variables:
        assert v in tds.open_dataset(out / "x_20200101.nc").data_vars, v
    batches = {}
    for name, gen, prov in (("t", BatchGenerator, LocalFileProvider),
                            ("j", JBatchGenerator, JLocalFileProvider)):
        bg = gen(prov(str(out), "x_{date}.nc"),
                 output_provider=prov(str(out), "y_{date}.nc"),
                 config=dcfg, seed=0)
        batches[name] = next(iter(bg))
    for got, want in zip(batches["t"], batches["j"]):
        np.testing.assert_array_equal(got, want)
    xb, yb = batches["t"]
    assert xb.shape == (2, 2, 24, 24, len(dcfg.input_variables))
    assert yb.shape == (2, 2, 24, 24, 2)
    assert np.isfinite(xb).all() and np.isfinite(yb).all()

    ckpt = tmp_path / "ck"
    state = tcli.train_main([
        "--inputs", str(out), "--outputs", str(out), "--checkpoint-dir",
        str(ckpt), "--steps", "1", "--batch-size", "2", "--patch-size",
        "24", "--sequence-length", "2", "--reconstruction-coefficient",
        "1.0", "--device", "cpu"])
    assert state.step == 1
    logged = json.loads((ckpt / "metrics.jsonl").read_text().splitlines()[0])
    assert logged["g_reco_loss"] > 0 and np.isfinite(logged["g_loss"])


class _FakeCds:
    """A ``cdsapi`` module whose client writes each requested day."""

    def __init__(self):
        self.requests = []
        self.Client = lambda: self

    def retrieve(self, name, request, target):
        self.requests.append((name, request, Path(target).name))
        Path(target).write_bytes(f"{name} {request['day']}".encode())


def test_era5_downloaders_issue_the_jax_requests(tmp_path, monkeypatch):
    fakes = {}
    for side, mod in (("j", jera5), ("t", tera5)):
        fakes[side] = _FakeCds()
        monkeypatch.setitem(sys.modules, "cdsapi", fakes[side])
        (tmp_path / side).mkdir()
        (tmp_path / side / "20200102_era5_surface_hourly.nc").touch()
        mod.download_ERA5(str(tmp_path / side), "2020-01-01", "2020-01-03")
    assert fakes["t"].requests == fakes["j"].requests
    assert len(fakes["t"].requests) == 5      # one surface day existed
    for side in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / side).iterdir()) == \
            sorted(p.name for p in (tmp_path / "j").iterdir())


class _FakeFtp:
    """An FTP archive served from a directory."""

    def __init__(self, root, failures=0):
        self.root, self.failures = root, failures

    def __call__(self, host, user, password, timeout):
        assert host == "giub-torrent.unibe.ch"
        return self

    def cwd(self, path):
        assert path == "COSMO-1_test"

    def retrlines(self, cmd, callback):
        assert cmd == "NLST"
        for p in sorted(self.root.iterdir()):
            callback(p.name)

    def retrbinary(self, cmd, callback):
        if self.failures:
            self.failures -= 1
            callback(b"trunc")
            raise EOFError("connection dropped")
        callback((self.root / cmd.split(" ", 1)[1]).read_bytes())

    def quit(self):
        pass


def test_cosmo_fetcher_mirrors_and_merges_as_jax(tmp_path, monkeypatch):
    server = tmp_path / "server"
    server.mkdir()
    lat, lon = np.linspace(46, 47, 5), np.linspace(6, 7, 6)
    for hour in range(3):
        t = np.datetime64("2020-01-01T00", "h") + np.timedelta64(hour, "h")
        jds.Dataset(
            {"U_10M": jds.DataArray(("time", "y_1", "x_1"), np.full(
                (1, 5, 6), hour, np.float32))},
            {"time": jds.DataArray(("time",), np.array([t])),
             "y_1": jds.DataArray(("y_1",), lat),
             "x_1": jds.DataArray(("x_1",), lon)},
        ).to_netcdf(server / f"cosmo-1_ana_20200101{hour:02d}.nc")
    for side, mod in (("j", jcosmo), ("t", tcosmo)):
        monkeypatch.setattr(mod, "FTP", _FakeFtp(server, failures=1))
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        mod.download_COSMO1("user", "pw", str(tmp_path / side), DAY,
                            "2020-01-02")
        assert sorted(p.name for p in (tmp_path / side).iterdir()) == \
            ["20200101.nc"]
    _assert_files_equal(tmp_path / "t" / "20200101.nc",
                        tmp_path / "j" / "20200101.nc")
    merged = tds.open_dataset(tmp_path / "t" / "20200101.nc")
    np.testing.assert_array_equal(merged["U_10M"].values[:, 0, 0], [0, 1, 2])
