"""The port's entry points across processes (windtpu_torch/cli.py): two
and four real ranks joined by gloo on the CPU (tests/torch_ranks.py) run
``cli.train_main`` with ``--coordinator-address/--num-processes
/--process-id``, and ``cli.main`` under torchrun's variables, against the
same commands in one process here.

As the JAX package's tests/test_multihost.py asks of it: the ranks end
with identical parameters, equal to a single-process ``train_main`` of the
same command, and only rank 0 writes checkpoints.  Ranks that would
restore different checkpoint steps all raise.  ``cli.main`` on the ranks
writes one NetCDF, from rank 0, equal to the single-process one.
"""

import json

import numpy as np
import pytest
import torch

from tests import torch_ranks
from windtpu_torch import api as tapi
from windtpu_torch import cli as tcli
from windtpu_torch.core.config import GANConfig, ModelConfig
from windtpu_torch.io import dataset as tds
from windtpu_torch.io.geotiff import write_geotiff_like
from windtpu_torch.network import WindDownscalingGAN
from windtpu_torch.weights import export_train_state

torch.set_num_threads(2)

WORLD = 2
WORLDS = [WORLD, 4]
TRAIN_ARGV = ["--inputs", "x", "--outputs", "y", "--synthetic", "--steps",
              "2", "--batch-size", "4", "--patch-size", "24",
              "--sequence-length", "2", "--g-lr", "2e-4", "--n-critic", "1",
              "--device", "cpu"]
NETWORK = dict(image_size=16, sequence_length=3, generator_features=16)
# The JAX package's tolerance for the |param| sums of two processes
# against one (tests/test_multihost.py): gloo's all-reduce and one
# process's reductions sum in different orders.
CHECKSUM_RTOL = 5e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks of both worlds, run the single-process commands here
    meanwhile, and collect everything by world size."""
    work = tmp_path_factory.mktemp("multiprocess")
    era5, dem = torch_ranks.era5_and_dem(tds, nt=6, nlat=4, nlon=5)
    (work / "era").mkdir()
    era5.to_netcdf(work / "era" / "20160401_era5_surface_hourly.nc")
    write_geotiff_like(work / "dem.tif", dem["band_data"].values[0],
                       dem["x"].values, dem["y"].values)
    main_argv = ["--era", str(work / "era"), "--dem", str(work / "dem.tif"),
                 "--date", "20160401", "--lon", "6.0:7.0", "--lat",
                 "45.0:46.0", "--device", "cpu"]
    works, procs = {}, {}
    for world in WORLDS:
        works[world] = wdir = work / f"world{world}"
        wdir.mkdir()
        (wdir / "config.json").write_text(json.dumps(dict(
            train_argv=TRAIN_ARGV, network=NETWORK,
            main_argv=main_argv + ["-o", str(wdir / "multi.nc")])))
        procs[world] = torch_ranks.launch("multiprocess", world, wdir)
    outs = {}
    try:
        single = tcli.train_main(TRAIN_ARGV + ["--checkpoint-dir",
                                               str(work / "ck_single")])
        net = WindDownscalingGAN(GANConfig(model=ModelConfig(**NETWORK)),
                                 device="cpu")
        get_network = tapi.get_network
        tapi.get_network = lambda weights_path=None, device=None: net
        try:
            tcli.main(main_argv + ["-o", str(work / "single.nc")])
        finally:
            tapi.get_network = get_network
    finally:
        for world in procs:
            outs[world] = torch_ranks.finish(procs[world])
    single = export_train_state(single)
    return {world: dict(
        work=wdir, single=single, single_nc=work / "single.nc",
        ranks=[dict(np.load(wdir / f"rank{r}.npz")) for r in range(world)],
        checks=[json.loads((wdir / f"rank{r}.json").read_text())
                for r in range(world)],
        outs=outs[world]) for world, wdir in works.items()}


@pytest.fixture(scope="module")
def run(runs):
    return runs[WORLD]


def _checksums(flat):
    return [sum(float(np.abs(v).sum()) for k, v in flat.items()
                if k.startswith(prefix)) for prefix in ("g_params/",
                                                        "d_params/")]


@pytest.mark.parametrize("world", WORLDS)
def test_train_main_ranks_hold_identical_parameters(runs, world):
    r0 = runs[world]["ranks"][0]
    assert int(r0["step"]) == 2
    for r in runs[world]["ranks"][1:]:
        assert sorted(r) == sorted(r0)
        for k in r0:
            np.testing.assert_allclose(r[k], r0[k], rtol=0, atol=0,
                                       err_msg=k)


def test_train_main_two_processes_equal_one(run):
    _assert_equals_single(run)


def test_train_main_four_processes_equal_one(runs):
    _assert_equals_single(runs[4])


def _assert_equals_single(run):
    got, want = run["ranks"][0], run["single"]
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(_checksums(got), _checksums(want),
                               rtol=CHECKSUM_RTOL)
    # Tighter than the checksums: every parameter and statistic, within
    # 1e-4 (f32 sums in another order over two Adam steps).
    for k in want:
        if "_opt/" not in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_only_rank_0_writes_checkpoints(runs, world):
    work = runs[world]["work"]
    assert sorted(p.name for p in (work / "ck_rank0").iterdir()) == [
        "metrics.jsonl", "step_00000002.pt"]
    for r in range(1, world):
        assert not (work / f"ck_rank{r}").exists() or not any(
            (work / f"ck_rank{r}").iterdir())


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_step_disagreement_raises_on_every_rank(runs, world):
    for checks in runs[world]["checks"]:
        assert "the ranks disagree on the checkpoint step" in \
            checks["disagreement"]
        assert str([2] + [-1] * (world - 1)) in checks["disagreement"]


def test_downscale_cli_on_two_ranks_writes_once(run):
    _assert_written_once(run)


def test_downscale_cli_under_torchrun_variables_at_four_ranks_writes_once(
        runs):
    """cli.main at 4 ranks named by torchrun's variables: tile-parallel
    over data 4, one NetCDF from rank 0, equal to the single process's."""
    _assert_written_once(runs[4])


def _assert_written_once(run):
    work = run["work"]
    assert ["wrote" in out for out in run["outs"]] == (
        [True] + [False] * (len(run["outs"]) - 1))
    got = tds.open_dataset(work / "multi.nc")
    want = tds.open_dataset(run["single_nc"])
    for var in ("u10", "v10"):
        a, b = np.asarray(got[var].values), np.asarray(want[var].values)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, equal_nan=True)
