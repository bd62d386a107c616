"""The port's training data pipeline and training entry point
(windtpu_torch/data/, cli.train_main) against windtpu's, on the CPU.

The batch pipeline is numpy on both sides, so batches from the same
providers and seed are held equal bit for bit.  The noise generators draw
from torch generators, which cannot reproduce JAX's threefry streams: they
are held to the JAX package's shapes, standard deviations and broadcast
pattern instead.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from windtpu.core.config import DataConfig as JDataConfig
from windtpu.data import batch as jbatch
from windtpu.data import decoders as jdecoders
from windtpu_torch import cli as tcli
from windtpu_torch.core.config import DataConfig
from windtpu_torch.data import (
    BatchGenerator,
    FlexibleNoiseGenerator,
    LocalFileProvider,
    NoiseGenerator,
    SyntheticDayProvider,
)
from windtpu_torch.data import decoders as tdecoders
from windtpu_torch.io.dataset import DataArray, Dataset
from windtpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)

CFG = dict(sequence_length=3, patch_size=16, batch_size=4,
           input_variables=("u10", "v10", "elevation"),
           output_variables=("U_10M", "V_10M"))
DATES = ["20200101", "20200102", "20200103"]


def _generators(seed=0, workers=1, transform=True, providers=None):
    """(JAX, port) BatchGenerators on the same days and seed."""
    out = []
    for mod, cfg_cls in ((jbatch, JDataConfig), (None, DataConfig)):
        cfg = cfg_cls(**CFG, transform=transform)
        if providers is not None:
            inp, outp = providers(mod)
        else:
            day = mod.SyntheticDayProvider if mod else SyntheticDayProvider
            inp = day(DATES, cfg.input_variables, ny=32, nx=40, nt=6)
            outp = day(DATES, cfg.output_variables, ny=32, nx=40, nt=6,
                       seed=5)
        gen = mod.BatchGenerator if mod else BatchGenerator
        out.append(gen(inp, output_provider=outp, config=cfg, seed=seed,
                       num_workers=workers))
    return out


def _take(bg, n):
    it = iter(bg)
    items = [next(it) for _ in range(n)]
    it.close()
    return items


@pytest.mark.parametrize("workers,transform", [(1, True), (3, True),
                                               (1, False)])
def test_batches_equal_jax_bit_for_bit(workers, transform):
    jbg, tbg = _generators(seed=6, workers=workers, transform=transform)
    for (jx, jy), (tx, ty) in zip(_take(jbg, 4), _take(tbg, 4)):
        assert tx.shape == (4, 3, 16, 16, 3) and ty.shape == (4, 3, 16, 16, 2)
        assert tx.dtype == jx.dtype == np.float32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_threaded_batches_do_not_depend_on_worker_count():
    _, one = _generators(seed=2, workers=2)
    _, three = _generators(seed=2, workers=3)
    for (xa, ya), (xb, yb) in zip(_take(one, 5), _take(three, 5)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_threaded_iterator_close_releases_workers():
    before = {t.ident for t in threading.enumerate()}
    _, bg = _generators(workers=2)
    it = iter(bg)
    next(it)
    time.sleep(0.3)     # let the workers block on the full queue
    it.close()
    deadline = time.time() + 5
    leaked = []
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.ident not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.1)
    assert not leaked, f"worker threads leaked: {leaked}"


def _write_days(directory, prefix, variables, seed, static=()):
    """NetCDF days written by the port's io, one per date; the ``static``
    variables have no time axis (a topography field)."""
    rng = np.random.RandomState(seed)
    directory.mkdir(exist_ok=True)
    for date in DATES[:2]:
        data = {}
        for v in variables:
            if v in static:
                data[v] = DataArray(("lat", "lon"), 1500.0 + 300.0 * rng.
                                    standard_normal((28, 32)).astype(
                                        np.float32))
            else:
                data[v] = DataArray(("time", "lat", "lon"), rng.
                                    standard_normal((5, 28, 32)).astype(
                                        np.float32))
        Dataset(data, {"time": DataArray(("time",), np.arange(5))}
                ).to_netcdf(directory / f"{prefix}_{date}.nc")


def test_local_file_provider_reads_port_netcdf_days(tmp_path):
    _write_days(tmp_path / "x", "x", CFG["input_variables"], 0,
                static=("elevation",))
    _write_days(tmp_path / "y", "y", CFG["output_variables"], 1)
    (tmp_path / "x" / "notes.txt").touch()

    def providers(mod):
        from windtpu.data import providers as jproviders

        cls = jproviders.LocalFileProvider if mod else LocalFileProvider
        return (cls(tmp_path / "x", "x_{date}.nc"),
                cls(tmp_path / "y", "y_{date}.nc"))

    inp, _ = providers(None)
    assert inp.available_dates == set(DATES[:2])
    jbg, tbg = _generators(seed=3, providers=providers)
    assert tbg.dates == DATES[:2]
    for (jx, jy), (tx, ty) in zip(_take(jbg, 3), _take(tbg, 3)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    # The static elevation is replicated over time and scaled by 1/1000
    # before the decoder's per-channel z-score.
    assert np.isfinite(tx).all()


DECODERS = [("NaiveDecoder", {}), ("NaiveDecoder", {"normalize": False}),
            ("WindSpeedDecoder", {}),
            ("WindSpeedDecoder", {"normalize": True}),
            ("WindComponentDecoder", {}),
            ("WindComponentDecoder", {"below_val": -5.0})]


@pytest.mark.parametrize("name,kw", DECODERS)
def test_decoders_equal_their_originals(name, kw):
    rng = np.random.RandomState(DECODERS.index((name, kw)))
    img = (4 * rng.standard_normal((3, 6, 7, 2))).astype(np.float32)
    img[0, 1, 2, 0] = 0.0
    img[1, 2, 3, 1] = np.nan
    jdec = getattr(jdecoders, name)(**kw)
    tdec = getattr(tdecoders, name)(**kw)
    np.testing.assert_array_equal(tdec(img.copy()), jdec(img.copy()))
    np.testing.assert_array_equal(tdec.normalize(img.copy()),
                                  jdec.normalize(img.copy()))
    np.testing.assert_array_equal(tdec.denormalize(img.copy()),
                                  jdec.denormalize(img.copy()))


def test_flexible_noise_shape_std_and_overrides():
    gen = FlexibleNoiseGenerator((4, 6, 16, 16, 20), std=0.1,
                                 random_seed=0)
    n = gen()
    assert n.shape == (4, 6, 16, 16, 20) and n.dtype == torch.float32
    assert abs(n.std().item() - 0.1) < 0.01
    assert abs(n.mean().item()) < 0.01
    n = gen(bs=2, channels=3, std=1.0)
    assert n.shape == (2, 6, 16, 16, 3)
    assert abs(n.std().item() - 1.0) < 0.05
    # sample() draws from the caller's generator only.
    a = gen.sample(torch.Generator().manual_seed(42))
    b = gen.sample(torch.Generator().manual_seed(42))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # Seeded wrappers repeat their draws.
    torch.testing.assert_close(
        FlexibleNoiseGenerator((2, 3, 4, 4, 2), random_seed=7)(),
        FlexibleNoiseGenerator((2, 3, 4, 4, 2), random_seed=7)(),
        rtol=0, atol=0)


def test_structured_noise_broadcast_pattern():
    n = NoiseGenerator((2, 4, 8, 8), std=1.0, random_seed=1)().numpy()
    assert n.shape == (2, 4, 8, 8, 4)
    # Channel 0 varies only along time.
    assert np.allclose(n[0, 0, :, :, 0], n[0, 0, 0, 0, 0])
    assert not np.allclose(n[0, 0, 0, 0, 0], n[0, 1, 0, 0, 0])
    # Channel 1 varies only along x (axis 2), channel 2 only along y.
    assert np.allclose(n[0, :, 3, :, 1], n[0, 0, 3, 0, 1])
    assert np.allclose(n[0, :, :, 5, 2], n[0, 0, 0, 5, 2])
    # Channel 3 varies along x and y but not time.
    assert np.allclose(n[0, :, 3, 5, 3], n[0, 0, 3, 5, 3])
    assert not np.allclose(n[0, 0, :, :, 3], n[0, 0, 0, 0, 3])
    big = NoiseGenerator((64, 8, 16, 16), std=0.5).sample(
        torch.Generator().manual_seed(0))
    assert abs(big[..., 3].std().item() - 0.5) < 0.02


def test_device_iterator_on_the_cpu():
    _, bg = _generators(seed=4)
    want = _take(_generators(seed=4)[1], 3)
    it = bg.as_device_iterator(device="cpu")
    for wx, wy in want:
        x, y = next(it)
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)


def test_device_iterator_later_slices_raise(monkeypatch):
    # The multi-GPU slice (A12) is ported: with a mesh, each rank takes its
    # contiguous rows of the global batch, as the JAX package's
    # as_device_iterator(mesh) does; what still raises is the card that is
    # not there.
    from windtpu_torch.core.mesh import Mesh

    want = _take(_generators(seed=4)[1], 2)
    for rank in range(2):
        mesh = Mesh(("data", "ensemble"), (2, 1), (rank, 0), {})
        it = _generators(seed=4)[1].as_device_iterator(device="cpu",
                                                       mesh=mesh)
        for wx, wy in want:
            x, y = next(it)
            per = wx.shape[0] // 2
            np.testing.assert_array_equal(
                x.numpy(), wx[rank * per:(rank + 1) * per])
            np.testing.assert_array_equal(
                y.numpy(), wy[rank * per:(rank + 1) * per])
    _, bg = _generators()
    odd = Mesh(("data",), (3,), (0,), {})
    with pytest.raises(ValueError, match="not divisible"):
        next(bg.as_device_iterator(device="cpu", mesh=odd))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(bg.as_device_iterator())


TRAIN_ARGS = ["--inputs", "unused", "--outputs", "unused", "--synthetic",
              "--steps", "2", "--batch-size", "2", "--patch-size", "24",
              "--sequence-length", "2", "--device", "cpu"]


def test_train_main_synthetic_writes_a_checkpoint(tmp_path):
    state = tcli.train_main(TRAIN_ARGS + ["--checkpoint-dir",
                                          str(tmp_path / "ck"),
                                          "--steps-per-call-unroll",
                                          "--spatial-ks"])
    assert state.step == 2
    assert ckpt.latest_checkpoint(tmp_path / "ck").endswith(
        "step_00000002.pt")
    logged = (tmp_path / "ck" / "metrics.jsonl").read_text()
    assert '"g_spatial_ks"' in logged
    assert state.generator.config.in_channels == len(
        DataConfig().input_variables)


def test_train_main_reads_netcdf_days(tmp_path):
    variables = DataConfig().input_variables
    _write_days(tmp_path / "x", "x", variables, 0,
                static=("tpi_500", "ridge_index_norm"))
    _write_days(tmp_path / "y", "y", DataConfig().output_variables, 1)
    args = [a for a in TRAIN_ARGS if a != "--synthetic"]
    args[1], args[3] = str(tmp_path / "x"), str(tmp_path / "y")
    state = tcli.train_main(args + ["--checkpoint-dir",
                                    str(tmp_path / "ck")])
    assert state.step == 2


@pytest.mark.parametrize("flag", [["--coordinator-address", "h:1"],
                                  ["--process-id", "0"]])
def test_train_main_later_slices_raise(tmp_path, flag):
    # Multi-process training (A12) is ported: one coordinator flag alone
    # now names the ones missing, before anything is read or written.
    # Two processes: tests/test_torch_multiprocess.py.
    with pytest.raises(ValueError, match="--num-processes"):
        tcli.train_main(TRAIN_ARGS + ["--checkpoint-dir", str(tmp_path)]
                        + flag)
    assert not (tmp_path / "metrics.jsonl").exists()


def test_train_main_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TRAIN_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.train_main(args + ["--checkpoint-dir", str(tmp_path)])


def test_config_fields_match():
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(
        JDataConfig())
