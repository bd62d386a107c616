"""The port's plots (windtpu_torch/viz.py) against windtpu/viz.py: both
packages draw the same fabricated Dataset, each from its own
``io.dataset``, into figures that agree in panels, titles, labels, color
limits and norms, plotted values and extents, for a chosen time index and
an all-NaN slice.  Agg backend, without cartopy on either side."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from windtpu import viz as jviz  # noqa: E402
from windtpu.io import dataset as jds  # noqa: E402
from windtpu_torch import viz as tviz  # noqa: E402
from windtpu_torch.io import dataset as tds  # noqa: E402


@pytest.fixture(autouse=True)
def no_cartopy(monkeypatch):
    for mod in (jviz, tviz):
        monkeypatch.setattr(mod, "_try_cartopy", lambda: (None, None))


def _wind(mod, all_nan=False):
    rng = np.random.RandomState(0)
    ny, nx, t = 12, 16, 3
    lon2, lat2 = np.meshgrid(np.linspace(5.0, 7.0, nx),
                             np.linspace(45.0, 46.0, ny))
    u = 4.0 * rng.standard_normal((t, ny, nx)).astype(np.float32)
    v = 2.0 * rng.standard_normal((t, ny, nx)).astype(np.float32)
    if all_nan:
        u[:] = np.nan
    return mod.Dataset(
        {"u10": mod.DataArray(("time", "y", "x"), u),
         "v10": mod.DataArray(("time", "y", "x"), v)},
        {"lon_1": mod.DataArray(("y", "x"), lon2),
         "lat_1": mod.DataArray(("y", "x"), lat2)})


def _dem(mod):
    rng = np.random.RandomState(1)
    ny, nx = 10, 14
    dem = np.abs(1200.0 * rng.standard_normal((1, ny, nx))).astype(
        np.float32)
    return mod.Dataset(
        {"band_data": mod.DataArray(("band", "y", "x"), dem)},
        {"x": mod.DataArray(("x",), np.linspace(6.0, 8.0, nx)),
         "y": mod.DataArray(("y",), np.linspace(47.0, 46.0, ny))})


CASES = {
    "wind": lambda viz, mod: viz.plot_wind_fields(_wind(mod), title="t"),
    "wind_extent_time": lambda viz, mod: viz.plot_wind_fields(
        _wind(mod), range_lon=(5.2, 6.8), range_lat=(45.1, 45.9),
        time_index=2),
    "wind_all_nan": lambda viz, mod: viz.plot_wind_fields(
        _wind(mod, all_nan=True)),
    "elevation": lambda viz, mod: viz.plot_elevation(
        _dem(mod), range_lon=(6.2, 7.8), range_lat=(46.1, 46.9)),
}


def _summary(fig):
    """What a reader of the figure sees, axes by axes."""
    fig.canvas.draw()
    out = []
    for ax in fig.axes:
        meshes = [c for c in ax.collections if hasattr(c, "get_clim")]
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(),
            xlim=ax.get_xlim(), ylim=ax.get_ylim(),
            meshes=[(m.get_clim(), type(m.norm).__name__,
                     np.ma.filled(m.get_array(), np.nan).tolist())
                    for m in meshes]))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_figures_equal_the_jax_package_figures(case):
    figs = [CASES[case](viz, mod) for viz, mod in ((tviz, tds), (jviz, jds))]
    try:
        got, want = (_summary(f) for f in figs)
    finally:
        for f in figs:
            plt.close(f)
    np.testing.assert_equal(got, want)
    panels = 1 if case == "elevation" else 2
    assert len(got) == 2 * panels          # a colorbar per panel
    clim = got[0]["meshes"][0][0]
    if case == "wind_all_nan":
        assert clim == (-1.0, 1.0)         # the documented fallback
    elif case == "wind_extent_time":
        u2 = np.asarray(_wind(tds)["u10"].values[2])
        assert clim[1] == pytest.approx(float(np.abs(u2).max()), rel=1e-6)
        assert got[0]["xlim"] == pytest.approx((5.2, 6.8))
    elif case == "elevation":
        assert got[0]["meshes"][0][1] == "LogNorm" and clim == (58, 4473)
