"""The plain reference against the port at a tiny size in float32 on the
CPU: variable shapes, the networks, the train step, the data pipeline,
the texture gate and the whole downscale.  The tests import both; the
reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.harness import subseed
from portbench.reference import data as RDATA
from portbench.reference import downscale as RD
from portbench.reference import gate as RG
from portbench.reference import networks as RN
from portbench.reference import params as RP
from portbench.reference import wgan_gp as RW
from portbench.reference.layers import FP32

from windtpu_torch.core.config import (DataConfig, GANConfig, ModelConfig,
                                       TrainConfig)
from windtpu_torch.models.discriminator import init_discriminator
from windtpu_torch.models.generator import init_generator

TINY = ModelConfig(image_size=24, sequence_length=3, generator_features=16,
                   discriminator_features=4)


@pytest.mark.parametrize("mc", [
    ModelConfig(),
    ModelConfig(image_size=32, in_channels=10, sequence_length=6),
    ModelConfig(image_size=24, generator_features=8, sequence_length=2),
    TINY,
], ids=["flagship", "train_main", "narrow_head", "tiny"])
def test_variable_shapes_match_the_port(mc):
    g, d = init_generator(mc, 0, "cpu"), init_discriminator(mc, 1, "cpu")
    gp, gs = RP.generator(mc.in_channels, mc.noise_channels, mc.out_channels,
                          mc.generator_features)
    dp, ds = RP.critic(mc.in_channels, mc.out_channels,
                       mc.discriminator_features, mc.image_size)
    for mod, p, s in ((g, gp, gs), (d, dp, ds)):
        assert {k: tuple(v.shape) for k, v in mod.named_parameters()} == p
        assert {k: tuple(v.shape) for k, v in mod.named_buffers()} == s


def _variables(mod):
    return ({k: v.detach().clone() for k, v in mod.named_parameters()},
            {k: v.clone() for k, v in mod.named_buffers()})


@pytest.mark.parametrize("train", [False, True])
def test_generator_matches_the_port(train):
    g = init_generator(TINY, 0, "cpu")
    p, s = _variables(g)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 3, 24, 24, 3, generator=gen)
    noise = torch.randn(2, 3, 24, 24, 20, generator=gen)
    want, moved = RN.generator(p, s, img, noise, FP32, train=train)
    got = g(img, noise, train=train)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    buffers = dict(g.named_buffers())
    assert set(moved) == (set(buffers) if train else set())
    for k, v in moved.items():
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_critic_matches_the_port(train):
    d = init_discriminator(TINY, 1, "cpu")
    p, s = _variables(d)
    gen = torch.Generator().manual_seed(2)
    low = torch.randn(2, 3, 24, 24, 3, generator=gen)
    high = 3 * torch.randn(2, 3, 24, 24, 2, generator=gen)
    want, moved = RN.critic(p, s, low, high, FP32, train=train)
    got = d(low, high, train=train)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    buffers = dict(d.named_buffers())
    for k, v in moved.items():
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=1e-6)


def test_train_step_matches_the_port():
    from windtpu_torch.train.state import create_train_state
    from windtpu_torch.train.wgan_gp import make_train_step

    cfg = GANConfig(model=TINY, train=TrainConfig(batch_size=2))
    st = create_train_state(cfg, seed=0, device="cpu")
    ref = RW.new_state(*_variables(st.generator),
                       *_variables(st.discriminator))
    step = make_train_step(cfg)
    t = cfg.train
    hp = dict(n_critic=t.n_critic, gp_weight=t.gp_weight,
              noise_std=t.noise_std, g_lr=t.g_learning_rate,
              d_lr=t.d_learning_rate, b1=t.adam_b1, b2=t.adam_b2,
              eps=t.adam_eps)
    gen = torch.Generator().manual_seed(5)
    low = torch.randn(2, 3, 24, 24, 3, generator=gen)
    high = 4 * torch.randn(2, 3, 24, 24, 2, generator=gen)
    rng, rng_ref = (torch.Generator().manual_seed(11) for _ in range(2))
    for _ in range(2):
        st, got = step(st, low, high, rng)
        ref, want = RW.step(ref, low, high,
                            RW.draws(3, 20, low.shape, 2, rng_ref), hp, FP32)
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=1e-4,
                                                  abs=1e-6), k
    for mod, net in ((st.generator, "g"), (st.discriminator, "d")):
        for k, v in mod.named_parameters():
            torch.testing.assert_close(v.detach(), ref[net][k], rtol=1e-4,
                                       atol=1e-6)
    for i, k in enumerate(st.g_opt.names):
        want = ref["g_mu"][k]
        torch.testing.assert_close(st.g_opt.state["mu"][i], want, rtol=1e-3,
                                   atol=1e-4 * float(want.abs().max()))


def test_batches_match_the_data_pipeline():
    from windtpu_torch.data import BatchGenerator, SyntheticDayProvider

    dcfg = DataConfig(sequence_length=3, patch_size=16, batch_size=3)
    dates = ["20200101", "20200102", "20200103"]
    bg = BatchGenerator(
        SyntheticDayProvider(dates, dcfg.input_variables, 32, 32, 8, seed=3),
        output_provider=SyntheticDayProvider(dates, dcfg.output_variables,
                                             32, 32, 8, seed=9),
        config=dcfg, num_workers=2, seed=1234567)
    it = iter(bg)
    days = [(RDATA.synthetic_day(d, dcfg.input_variables, 3, 32, 32, 8),
             RDATA.synthetic_day(d, dcfg.output_variables, 9, 32, 32, 8))
            for d in dates]
    for i in range(5):
        x, y = next(it)
        rx, ry = RDATA.batch(days, i, 1234567, 3, 3, 16,
                             dcfg.input_variables, dcfg.output_variables)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    it.close()


def test_host_gate_matches_the_port():
    from windtpu_torch import api
    from windtpu_torch.models.texture_gate import (apply_gate_targeted,
                                                   load_gate_npz,
                                                   predict_log_energy_np)

    gate = load_gate_npz(api.BUNDLED_GATE)
    rng = np.random.default_rng(4)
    field = rng.standard_normal((6, 40, 52, 3)).astype(np.float32)
    np.testing.assert_allclose(RG.predict_log_energy_np(gate, field),
                               predict_log_energy_np(gate, field),
                               rtol=1e-5, atol=1e-5)
    fake = torch.as_tensor(3 * rng.standard_normal((6, 40, 52, 2)),
                           dtype=torch.float32)
    fake[0, :5, :5] = float("nan")
    target = torch.tensor([0.3, 0.02])
    want = RG.apply_gate_targeted(target, 1e-3, fake)
    got = apply_gate_targeted(target, torch.tensor(1e-3), fake)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


def test_downscale_matches_the_port():
    import dataclasses

    from portbench.drivers.downscale import datasets
    from windtpu_torch import api
    from windtpu_torch.models.texture_gate import load_gate_npz
    from windtpu_torch.network import WindDownscalingGAN

    mc = dataclasses.replace(TINY, sequence_length=2)
    cfg = dataclasses.replace(api.flagship_config(), model=mc)
    net = WindDownscalingGAN(cfg, device="cpu")
    gate = load_gate_npz(api.BUNDLED_GATE)
    net.texture_gate = gate
    shapes, state = RP.generator(3, 20, 2, 16)
    p, s = inputs.weights(shapes, state, 7, "cpu")
    net.generator.load_state_dict({**p, **s})
    era5 = inputs.era5_days(99, 1, 4, 3, 4)[0]
    topo = inputs.dem(99, 4, 3)
    day, raster = datasets(era5, topo)
    seed = subseed(99, 1)
    res = api.downscale(day, raster, network=net, device="cpu", seed=seed)
    got = np.stack([res["u10"].values, res["v10"].values], -1)
    want = RD.downscale(era5, topo, p, s, gate, seed, FP32, "cpu", img=24,
                        seq=2)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
