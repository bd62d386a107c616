"""The port's texture gate (windtpu_torch/models/texture_gate.py) against
windtpu/models/texture_gate.py: the torch.fft band rescale, features,
energy prediction, gains and gated field against the jnp ones on the same
numpy inputs and parameters, the gradient of the fit's loss, the ``.npz``
files across packages, and the numpy host twins against their
originals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.models import texture_gate as jtg
from windtpu_torch.api import BUNDLED_GATE
from windtpu_torch.models import texture_gate as ttg

torch.set_num_threads(2)


def _canvas(seed, amplitude=1.0, shape=(3, 40, 50, 2)):
    rng = np.random.RandomState(seed)
    fake = (amplitude * rng.standard_normal(shape)).astype(np.float32)
    fake[1, 3:6, 7:12, 0] = np.nan
    fake[:, 30:, 45:, :] = np.nan
    return fake


@pytest.mark.parametrize("case", ["amplify", "attenuate", "floor",
                                  "per_member"])
def test_apply_gate_targeted_matches_jax(case):
    fake = _canvas(0)
    floor = np.float32(1e-3)
    if case == "amplify":
        target = np.array([2.0, 1.5], np.float32)
    elif case == "attenuate":
        target = np.array([0.05, 0.2], np.float32)
    elif case == "floor":
        # Prediction and measurement both under the floor on channel 0:
        # gain 1 there, whatever the target.
        fake = _canvas(1, amplitude=1e-3)
        fake[..., 1] *= 1e3
        target = np.array([1e-4, 0.5], np.float32)
    else:
        fake = np.stack([_canvas(2), _canvas(3)])
        target = np.array([[0.5, 2.0], [1.0, 0.1]], np.float32)
    want = np.asarray(jtg.apply_gate_targeted(
        jnp.asarray(target), jnp.asarray(floor), jnp.asarray(fake)))
    got = ttg.apply_gate_targeted(torch.from_numpy(target),
                                  torch.tensor(floor),
                                  torch.from_numpy(fake)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(fake))
    # f32 FFTs from two libraries (pocketfft vs XLA's).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                               equal_nan=True)
    if case == "floor":
        np.testing.assert_allclose(got[..., 0], fake[..., 0], rtol=1e-4,
                                   atol=1e-8, equal_nan=True)


def test_host_twins_equal_their_originals():
    rng = np.random.RandomState(4)
    low = rng.standard_normal((2, 3, 20, 24, 3)).astype(np.float32)
    params = ttg.load_gate_npz(BUNDLED_GATE)
    jparams = jtg.load_gate_npz(BUNDLED_GATE)
    assert sorted(params) == sorted(jparams)
    for k in params:
        np.testing.assert_array_equal(params[k], np.asarray(jparams[k]))
    np.testing.assert_array_equal(ttg._np_gauss(20, 24),
                                  jtg._np_gauss(20, 24))
    np.testing.assert_array_equal(ttg._np_hp_energy(low[..., 0]),
                                  jtg._np_hp_energy(low[..., 0]))
    np.testing.assert_array_equal(ttg.features_np(low), jtg.features_np(low))
    np.testing.assert_array_equal(ttg.predict_log_energy_np(params, low),
                                  jtg.predict_log_energy_np(jparams, low))
    fake = _canvas(5)
    target = np.array([0.7, 0.02], np.float32)
    np.testing.assert_array_equal(
        ttg.apply_gate_targeted_np(target, params["floor"], fake),
        jtg.apply_gate_targeted_np(target, jparams["floor"], fake))


def _low(seed, shape=(2, 3, 20, 24)):
    """Blurred-wind-like u, v and an elevation channel (km), from seed."""
    rng = np.random.RandomState(seed)
    low = rng.standard_normal(shape + (3,)).astype(np.float32)
    low[..., :2] += np.array([3.0, -1.0], np.float32)
    low[..., 2] = np.abs(low[..., 2]) + 0.5
    return low


def _params(kind):
    if kind == "bundled":
        return ttg.load_gate_npz(BUNDLED_GATE)
    params = ttg.init_params(torch.Generator().manual_seed(1))
    params["floor"] = np.asarray(1e-6, np.float32)
    return params


def test_features_match_jax():
    low = _low(0)
    want = np.asarray(jtg._features(jnp.asarray(low)))
    got = ttg._features(torch.from_numpy(low)).numpy()
    assert got.shape == want.shape == (2, 2, ttg.N_FEATURES)
    assert ttg.N_FEATURES == jtg.N_FEATURES
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # The numpy twin computes the same features in complex128.
    np.testing.assert_allclose(got, ttg.features_np(low), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["bundled", "fresh"])
def test_device_gate_matches_jax(kind):
    params = _params(kind)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    low, fake = _low(1), 2.0 * _low(2)[..., :2]
    tlow, tfake = torch.from_numpy(low), torch.from_numpy(fake)
    np.testing.assert_allclose(
        ttg.predict_log_energy(params, tlow).numpy(),
        np.asarray(jtg.predict_log_energy(jparams, jnp.asarray(low))),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ttg.gate_gains(params, tlow, tfake).numpy(),
        np.asarray(jtg.gate_gains(jparams, jnp.asarray(low),
                                  jnp.asarray(fake))),
        rtol=1e-4, atol=1e-4)
    got = ttg.apply_gate(params, tlow, tfake).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jtg.apply_gate(jparams, jnp.asarray(low),
                                       jnp.asarray(fake))),
        rtol=1e-4, atol=1e-4)
    # The protocol path equals the API's split path: the host prediction,
    # then the targeted gate (as tests/test_texture_gate.py holds JAX's).
    split = ttg.apply_gate_targeted(
        torch.from_numpy(np.exp(ttg.predict_log_energy_np(params, low))),
        torch.tensor(params["floor"]), tfake).numpy()
    np.testing.assert_allclose(got, split, rtol=1e-4, atol=1e-4)


def _lowpass_hp_energy(field):
    """The high-pass energy as fft2, Gaussian, ifft2 and the mean square
    of the difference: the form the power-spectrum one replaced."""
    g = ttg._gauss_multiplier(field.shape[-2], field.shape[-1], field.device)
    hp = field - torch.fft.ifft2(torch.fft.fft2(field) * g).real
    return torch.mean(hp * hp, dim=(-3, -2, -1))


# Sides that are not powers of two: 26 x 3 by 18 x 4 ERA5 cells, and an
# odd width, whose rfft2 has no Nyquist column.
ODD_SIDES = [(6, 78, 72), (6, 78, 73)]


@pytest.mark.parametrize("shape", ODD_SIDES)
def test_power_spectrum_hp_energy_equals_the_lowpass_form(shape):
    low = torch.from_numpy(_low(5, shape))
    for c in range(3):
        np.testing.assert_allclose(
            ttg._hp_energy(low[..., c]).numpy(),
            _lowpass_hp_energy(low[..., c]).numpy(), rtol=1e-5, err_msg=c)


@pytest.mark.parametrize("kind", ["bundled", "fresh"])
@pytest.mark.parametrize("shape", ODD_SIDES)
def test_device_targets_equal_the_host_route(kind, shape):
    """The target energies api.predict hands the gate: the device route
    on the monolithic path, the host one on the streamed path."""
    params = _params(kind)
    low = _low(6, shape)
    calls = ttg.predict_log_energy.calls
    got = torch.exp(ttg.predict_log_energy(params, torch.from_numpy(low)))
    assert ttg.predict_log_energy.calls == calls + 1
    assert got.shape == (2,)
    np.testing.assert_allclose(
        got.numpy(), np.exp(ttg.predict_log_energy_np(params, low)),
        rtol=1e-5)


def test_fit_loss_gradient_matches_jax():
    """The fit's loss, the mean squared error of predict_log_energy
    against target log energies, differentiated for w1..b3 on both
    sides."""
    params = _params("fresh")
    params["f_mu"] = np.linspace(-1, 1, ttg.N_FEATURES).astype(np.float32)
    params["f_sd"] = np.linspace(0.5, 2, ttg.N_FEATURES).astype(np.float32)
    low = _low(3)
    target = np.random.RandomState(4).standard_normal((2, 2)).astype(
        np.float32)
    trainable = ("w1", "b1", "w2", "b2", "w3", "b3")

    def jloss(tp):
        pred = jtg.predict_log_energy(
            {**{k: jnp.asarray(v) for k, v in params.items()}, **tp},
            jnp.asarray(low))
        return jnp.mean((pred - target) ** 2)

    want = jax.grad(jloss)({k: jnp.asarray(params[k]) for k in trainable})
    tp = {k: torch.tensor(params[k], requires_grad=True) for k in trainable}
    pred = ttg.predict_log_energy({**params, **tp}, torch.from_numpy(low))
    loss = torch.mean((pred - torch.from_numpy(target)) ** 2)
    got = dict(zip(trainable, torch.autograd.grad(loss, list(tp.values()))))
    for k in trainable:
        assert float(np.abs(np.asarray(want[k])).max()) > 0, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gate_npz_is_read_back_bit_for_bit_by_the_other_package(tmp_path,
                                                                writer):
    params = _params("fresh")
    params["w1"] = torch.from_numpy(params["w1"]).requires_grad_()
    path = tmp_path / "gate.npz"
    if writer == "port":
        ttg.save_gate_npz(path, params)
        loaded = {k: np.asarray(v)
                  for k, v in jtg.load_gate_npz(path).items()}
    else:
        jtg.save_gate_npz(str(path), {k: jnp.asarray(
            v.detach().numpy() if k == "w1" else v)
            for k, v in params.items()})
        loaded = ttg.load_gate_npz(path)
    assert sorted(loaded) == sorted(params)
    for k, v in params.items():
        v = v.detach().numpy() if k == "w1" else v
        assert loaded[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_init_params_keeps_jax_shapes_and_scales():
    want = jtg.init_params(jax.random.key(0), hidden=256)
    got = ttg.init_params(torch.Generator().manual_seed(0), hidden=256)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == np.float32, k
    for k in ("b1", "b2", "b3", "f_mu"):
        np.testing.assert_array_equal(got[k], 0.0)
    np.testing.assert_array_equal(got["f_sd"], 1.0)
    assert float(got["floor"]) == float(want["floor"]) == np.float32(1e-3)
    for k, fan_in in (("w1", ttg.N_FEATURES), ("w2", 256), ("w3", 256)):
        assert abs(got[k].std() * np.sqrt(fan_in) - 1.0) < 0.1, k
        assert abs(got[k].mean() * np.sqrt(fan_in)) < 0.1, k
    again = ttg.init_params(torch.Generator().manual_seed(0), hidden=256)
    other = ttg.init_params(torch.Generator().manual_seed(1), hidden=256)
    np.testing.assert_array_equal(again["w2"], got["w2"])
    assert not np.array_equal(other["w2"], got["w2"])
