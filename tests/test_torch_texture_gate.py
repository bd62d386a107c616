"""The port's texture gate (windtpu_torch/models/texture_gate.py) against
windtpu/models/texture_gate.py: the torch.fft band rescale against the
jnp one, and the numpy host twins against their originals."""

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
