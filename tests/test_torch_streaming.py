"""The port's streaming engine, ensembles and the API's engine choice
(windtpu_torch/infer/streaming.py, infer/engine.py, api.py) against
windtpu's, on the CPU at the tiny config of tests/test_streaming.py.

Both sides carry the same generator weights; wherever the two packages are
compared the noise is off (noise_std=0), since torch cannot reproduce JAX's
threefry streams.  The port's own engines are compared with noise on.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from tests.test_torch_api import _inputs
from windtpu import api as japi
from windtpu.core.config import GANConfig as JGANConfig
from windtpu.core.config import InferenceConfig as JInferenceConfig
from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.infer import engine as jengine
from windtpu.infer import streaming as jstreaming
from windtpu.infer.template import build_high_res_template_from_era5 as j_tpl
from windtpu.infer.template import process_era5 as j_era5
from windtpu.infer.template import process_topo as j_topo
from windtpu.infer.tiling import TilingPlan as JTilingPlan
from windtpu.io import dataset as jds
from windtpu_torch import api as tapi
from windtpu_torch.core.config import GANConfig, InferenceConfig, ModelConfig
from windtpu_torch.infer import engine, streaming
from windtpu_torch.infer.template import (
    build_high_res_template_from_era5,
    process_era5,
    process_topo,
)
from windtpu_torch.infer.tiling import TilingPlan
from windtpu_torch.io import dataset as tds
from windtpu_torch.network import WindDownscalingGAN
from windtpu_torch.weights import export_flax_variables

torch.set_num_threads(2)

MODEL = dict(image_size=32, in_channels=3, noise_channels=2, out_channels=2,
             sequence_length=4, generator_features=16,
             discriminator_features=8)
INFER = dict(sequence_length=4, image_size=32, noise_channels=2,
             border_crop=2, group_size=4, overlap_factor=0.5)
# The JAX package's streaming tolerance (fp64 host statistics against the
# engine's f32 ones, and across frameworks f32 conv summation order).
ATOL, RTOL = 2e-3, 1e-3
# Plan of tests/test_streaming.py:79-104: h - img < 17 <= h - img + crop,
# so the covered window runs past the 48-px field.
OOB = dict(image_size=32, sequence_length=4, pixels_lat=48, pixels_lon=48,
           time_window=4, starts_x=(0, 16), starts_y=(0, 17),
           num_time_chunks=1)


def _field(t=4, h=48, w=48, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (t, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """(JAX generator variables, the port's network) with the same weights:
    the port's seeded initializer's, carried across in the flat flax
    layout (cheaper than tracing the JAX initializer)."""
    tnet = WindDownscalingGAN(GANConfig(model=ModelConfig(**MODEL)),
                              device="cpu")
    flat = export_flax_variables(tnet.generator)
    jv = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                        sep="/")
    return jv, tnet


def _assert_seam_identical(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    assert m.any()
    np.testing.assert_allclose(got[m], want[m], atol=atol, rtol=rtol)


def test_out_of_bounds_plan_matches_jax_engine(weights):
    """The monolithic engine clamps its gather and its cropped stitch like
    XLA's dynamic_slice / dynamic_update_slice (it raised IndexError on
    this plan before)."""
    jv, tnet = weights
    field = _field(seed=9)
    icfg = dict(INFER, noise_std=0.0)
    want, _ = jengine.downscale_field(
        jv, field, JModelConfig(**MODEL), JInferenceConfig(**icfg),
        key=jax.random.key(13), plan=JTilingPlan(**OOB))
    got, _ = engine.downscale_field(
        tnet.generator, field, ModelConfig(**MODEL),
        InferenceConfig(**icfg), generator=13, plan=TilingPlan(**OOB),
        device="cpu")
    # f32 end to end on both sides; conv summation order differs.
    _assert_seam_identical(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["quirk", "per_channel", "nan_holes",
                                  "out_of_bounds"])
def test_streaming_matches_jax_streaming(weights, case):
    jv, tnet = weights
    icfg = dict(INFER, noise_std=0.0,
                replicate_normalization_quirk=case != "per_channel")
    field = _field(seed=3 if case == "per_channel" else 5)
    if case == "nan_holes":
        field[:, :3, :3, 0] = np.nan
    plans = ((JTilingPlan(**OOB), TilingPlan(**OOB))
             if case == "out_of_bounds" else (None, None))
    want, _ = jstreaming.downscale_field_streaming(
        jv, field, JModelConfig(**MODEL), JInferenceConfig(**icfg),
        key=jax.random.key(7), plan=plans[0])
    got, _ = streaming.downscale_field_streaming(
        tnet.generator, field, ModelConfig(**MODEL),
        InferenceConfig(**icfg), generator=7, plan=plans[1], device="cpu")
    # With NaN holes: both generators' bilinear upsample makes the whole
    # (b, t, c) plane of a NaN input NaN, so the NaN cells are equal too.
    # Both sides take fp64 host statistics and f32 forwards.
    _assert_seam_identical(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("plan", [None, "out_of_bounds"])
def test_streaming_matches_monolithic_with_noise(weights, plan):
    """Same seed, same noise draws group by group: the two engines agree up
    to their statistics' precision (fp64 on the host, f32 on the device)."""
    _, tnet = weights
    field = _field(seed=1)
    plan = TilingPlan(**OOB) if plan else None
    args = (tnet.generator, field, ModelConfig(**MODEL),
            InferenceConfig(**INFER))
    on_device, dplan = engine.downscale_field(*args, generator=4, plan=plan,
                                              device="cpu")
    streamed, splan = streaming.downscale_field_streaming(
        *args, generator=torch.Generator().manual_seed(4), plan=plan,
        device="cpu")
    assert splan.patch_origins().tolist() == dplan.patch_origins().tolist()
    _assert_seam_identical(streamed, on_device.numpy())


def test_bf16_transfers_match_f32_at_the_quantum(weights):
    _, tnet = weights
    field = _field(h=48, w=64)
    args = (tnet.generator, field, ModelConfig(**MODEL))
    a, _ = streaming.downscale_field_streaming(
        *args, InferenceConfig(**INFER), generator=7, device="cpu")
    b, _ = streaming.downscale_field_streaming(
        *args, InferenceConfig(**INFER, streaming_transfer_dtype="bfloat16"),
        generator=7, device="cpu")
    # Same noise, same stitch; only the transfers' rounding differs (bf16
    # has 8 mantissa bits: 2^-8 of the value scale).
    _assert_seam_identical(b, a, atol=2e-2, rtol=0)


@pytest.mark.parametrize("engine_name", ["monolithic", "streaming"])
def test_fused_ensemble_matches_single_members(weights, engine_name):
    _, tnet = weights
    run = (engine.downscale_field if engine_name == "monolithic"
           else streaming.downscale_field_streaming)
    field = _field(seed=3, w=64)
    args = (tnet.generator, field, ModelConfig(**MODEL),
            InferenceConfig(**INFER))
    seeds = [11, 12, 13]
    fused, _ = run(*args, ensemble_generators=seeds, device="cpu")
    singles = np.stack([np.asarray(run(*args, generator=s, device="cpu")[0])
                        for s in seeds])
    fused = np.asarray(fused)
    # One batched forward against three: the convs' summation order may
    # differ with the batch size.
    _assert_seam_identical(fused, singles, atol=1e-5, rtol=1e-5)
    m = ~np.isnan(fused[0])
    assert not np.allclose(fused[0][m], fused[1][m])


@pytest.fixture(scope="module")
def api_setup(weights):
    jv, tnet = weights
    gate = str(tapi.BUNDLED_GATE)
    jnet = types.SimpleNamespace(
        cfg=JGANConfig(model=JModelConfig(**MODEL)), generator_variables=jv,
        texture_gate=None)
    era5_j, dem_j = _inputs(jds, nt=4)
    era5_t, dem_t = _inputs(tds, nt=4)
    jt, tt = j_tpl(era5_j), build_high_res_template_from_era5(era5_t)
    return (jnet, (j_era5(era5_j, jt), j_topo(dem_j, jt), jt),
            tnet, (process_era5(era5_t, tt), process_topo(dem_t, tt), tt),
            gate)


@pytest.mark.parametrize("members,stream", [(3, False), (1, True), (3, True)])
def test_predict_matches_jax(api_setup, members, stream):
    """api.predict with members and/or streaming against the JAX package's,
    noise off, with the bundled texture gate (on the device for the
    monolithic engine, on the host for streaming)."""
    jnet, jin, tnet, tin, gate = api_setup
    want = japi.predict(*jin, overlap_factor=0.01, network=jnet,
                        key=jax.random.key(0), ensemble_members=members,
                        noise_std=0.0, mesh=None, streaming=stream,
                        texture_gate=gate)
    got = tapi.predict(*tin, overlap_factor=0.01, network=tnet, seed=0,
                       ensemble_members=members, noise_std=0.0,
                       streaming=stream, texture_gate=gate, device="cpu")
    mode = "streaming" if stream else ("ensemble" if members > 1
                                       else "single")
    # The port also says where the gate predicted its target energies.
    route = "host" if stream else "device"
    assert tapi.last_run_info() == {**japi.last_run_info(), "gate": route}
    assert japi.last_run_info() == {
        "mode": mode, "mesh_axes": None, "ensemble_sharded": False,
        "n_devices": 1, "texture_gate": True}
    dims = (("member",) if members > 1 else ()) + ("time", "lat_1", "lon_1")
    for var in ("u10", "v10"):
        assert got[var].dims == want[var].dims == dims
        _assert_seam_identical(got[var].values, want[var].values,
                               atol=1e-4, rtol=1e-4)
    if members > 1:
        np.testing.assert_array_equal(got["member"].values, np.arange(3))


def test_predict_member_equals_single_run_with_its_seed(api_setup):
    _, _, tnet, tin, _ = api_setup
    kw = dict(overlap_factor=0.01, network=tnet, texture_gate=False,
              device="cpu")
    ens = tapi.predict(*tin, seed=5, ensemble_members=3, **kw)
    seeds = tapi.member_seeds(5, 3)
    assert len(set(seeds)) == 3 and seeds == tapi.member_seeds(5, 3)
    one = tapi.predict(*tin, seed=seeds[2], **kw)
    _assert_seam_identical(ens["u10"].values[2], one["u10"].values,
                           atol=1e-5, rtol=1e-5)
    a, b = ens["u10"].values[0], ens["u10"].values[1]
    m = ~np.isnan(a)
    assert not np.allclose(a[m], b[m])


def test_auto_trigger_on_memory_budget(api_setup, monkeypatch):
    """streaming='auto' flips to the host engine exactly when the resident
    domain estimate crosses $WINDTPU_STREAMING_BYTES."""
    _, _, tnet, tin, _ = api_setup
    kw = dict(overlap_factor=0.01, network=tnet, texture_gate=False,
              device="cpu")
    monkeypatch.setenv("WINDTPU_STREAMING_BYTES", "1")
    tapi.predict(*tin, **kw)
    assert tapi.last_run_info()["mode"] == "streaming"
    monkeypatch.setenv("WINDTPU_STREAMING_BYTES", str(1 << 40))
    tapi.predict(*tin, **kw)
    assert tapi.last_run_info()["mode"] == "single"
    monkeypatch.delenv("WINDTPU_STREAMING_BYTES")
    assert tapi._streaming_threshold() == tapi._STREAMING_DEFAULT_BYTES


def test_engine_memory_estimate_formula():
    # field(in) + canvas(out) + canvas-sized buffer(out) + coverage(1), f32.
    assert tapi._engine_hbm_bytes(24, 100, 200, 3, 2) == \
        4 * 24 * 100 * 200 * (3 + 2 + 2 + 1)
    # Members multiply the canvas terms only.
    assert tapi._engine_hbm_bytes(24, 100, 200, 3, 2,
                                  members_per_device=4) == \
        4 * 24 * 100 * 200 * (3 + 4 * (2 + 2) + 1)
    for args in [(24, 100, 200, 3, 2, 1), (7, 33, 65, 3, 2, 5)]:
        assert tapi._engine_hbm_bytes(*args) == japi._engine_hbm_bytes(*args)


def test_auto_trigger_accounts_for_ensemble_members(api_setup, monkeypatch):
    """A multi-member monolithic run holds one canvas per member: the
    threshold trips on the member-scaled estimate."""
    _, _, tnet, tin, _ = api_setup
    t = tin[0]["u10"].shape[0]
    h, w = tin[2].sizes["lat_1"], tin[2].sizes["lon_1"]
    one = tapi._engine_hbm_bytes(t, h, w, 3, 2, members_per_device=1)
    eight = tapi._engine_hbm_bytes(t, h, w, 3, 2, members_per_device=8)
    assert eight > one
    monkeypatch.setenv("WINDTPU_STREAMING_BYTES", str((one + eight) // 2))
    kw = dict(overlap_factor=0.01, network=tnet, texture_gate=False,
              device="cpu")
    tapi.predict(*tin, **kw)
    assert tapi.last_run_info()["mode"] == "single"
    out = tapi.predict(*tin, ensemble_members=8, **kw)
    assert tapi.last_run_info()["mode"] == "streaming"
    assert out["u10"].dims[0] == "member" and out["u10"].shape[0] == 8



def test_cli_ensemble_writes_the_member_axis(api_setup, tmp_path,
                                             monkeypatch):
    from windtpu_torch import cli as tcli
    from windtpu_torch.io.geotiff import write_geotiff_like

    _, _, tnet, _, _ = api_setup
    era5, dem = _inputs(tds, nt=4)
    (tmp_path / "era").mkdir()
    era5.to_netcdf(tmp_path / "era" / "20160401_era5_surface_hourly.nc")
    write_geotiff_like(tmp_path / "dem.tif", dem["band_data"].values[0],
                       dem["x"].values, dem["y"].values)
    monkeypatch.setattr(tapi, "get_network",
                        lambda weights_path=None, device=None: tnet)
    tcli.main(["--era", str(tmp_path / "era"), "--dem",
               str(tmp_path / "dem.tif"), "--date", "20160401",
               "--ensemble", "2", "--no-texture-gate", "--device", "cpu",
               "-o", str(tmp_path / "out.nc")])
    assert tapi.last_run_info()["mode"] == "ensemble"
    out = tds.open_dataset(tmp_path / "out.nc")
    assert out["u10"].dims == ("member", "time", "lat_1", "lon_1")
    np.testing.assert_array_equal(out["member"].values, [0, 1])
    u = out["u10"].values
    assert np.isfinite(u).all() and not np.allclose(u[0], u[1])


@pytest.mark.gpu
def test_streaming_on_the_card_matches_the_monolithic_engine(weights):
    """The card's pipelined path (pinned staging, side-stream uploads,
    events) against the monolithic engine on the card, noise on, one
    member and three; the CPU tests reach only the synchronous path."""
    if not torch.cuda.is_available():
        pytest.skip("the pipelined streaming path runs only on a card")
    _, tnet = weights
    gen = WindDownscalingGAN(GANConfig(model=ModelConfig(**MODEL)),
                             device="cuda").generator
    gen.load_state_dict(tnet.generator.state_dict())
    field = _field(seed=2, h=80, w=112)
    for icfg in (InferenceConfig(**INFER), InferenceConfig(
            **INFER, streaming_transfer_dtype="bfloat16")):
        args = (gen, field, ModelConfig(**MODEL), icfg)
        for kw in (dict(generator=3), dict(ensemble_generators=[3, 4, 5])):
            on_device, _ = engine.downscale_field(*args, device="cuda", **kw)
            streamed, _ = streaming.downscale_field_streaming(
                *args, device="cuda", **kw)
            # f32 network: bf16 transfers round the inputs and outputs.
            tol = 2e-2 if icfg.streaming_transfer_dtype == "bfloat16" \
                else ATOL
            _assert_seam_identical(streamed, on_device.cpu().numpy(),
                                   atol=tol, rtol=RTOL)
