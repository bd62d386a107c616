"""The port's metric suite (windtpu_torch/metrics/metrics.py) against the
JAX package's and against the numpy oracles, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windtpu.metrics import metrics as JM
from windtpu_torch.metrics import metrics as M
from windtpu_torch.metrics import oracles as O

torch.set_num_threads(2)

# name -> (port, JAX, numpy oracle or None, atol)
PAIRWISE = {
    "wind_speed_weighted_rmse": (M.wind_speed_weighted_rmse,
                                 JM.wind_speed_weighted_rmse,
                                 O.wind_speed_weighted_rmse_np, 1e-5),
    "extreme_weighted_rmse": (M.extreme_weighted_rmse,
                              JM.extreme_weighted_rmse,
                              O.extreme_weighted_rmse_np, 1e-5),
    "wind_speed_rmse": (M.wind_speed_rmse, JM.wind_speed_rmse,
                        O.wind_speed_rmse_np, 1e-5),
    "angular_cosine_distance": (M.angular_cosine_distance,
                                JM.angular_cosine_distance,
                                O.angular_cosine_distance_np, 1e-5),
    "opposite_cosine_similarity": (M.opposite_cosine_similarity,
                                   JM.opposite_cosine_similarity, None,
                                   1e-5),
    # Decibels of a power-spectrum ratio: values of tens, FFTs from three
    # libraries.
    "log_spectral_distance": (M.log_spectral_distance,
                              JM.log_spectral_distance,
                              O.log_spectral_distance_np, 1e-4),
}


def fields(seed, shape=(3, 4, 10, 12, 2)):
    rng = np.random.default_rng(seed)
    real = 4.0 * rng.standard_normal(shape, dtype=np.float32)
    fake = real + rng.standard_normal(shape, dtype=np.float32)
    return real, fake


@pytest.mark.parametrize("name", sorted(PAIRWISE))
def test_metric_matches_jax_and_oracle(name):
    port, jaxfn, oracle, atol = PAIRWISE[name]
    real, fake = fields(seed=sorted(PAIRWISE).index(name))
    got = port(torch.from_numpy(real), torch.from_numpy(fake)).numpy()
    want = np.asarray(jaxfn(jnp.asarray(real), jnp.asarray(fake)))
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if oracle is not None:
        np.testing.assert_allclose(got, oracle(real, fake), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name", sorted(PAIRWISE))
def test_metric_zeroes_nans_where_jax_does(name):
    port, jaxfn, _, atol = PAIRWISE[name]
    real, fake = fields(seed=11)
    fake[0, 1, 2, 3, 0] = np.nan
    real[2, 0, 0, 0, 1] = np.nan
    got = port(torch.from_numpy(real), torch.from_numpy(fake)).numpy()
    want = np.asarray(jaxfn(jnp.asarray(real), jnp.asarray(fake)))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)


def test_extreme_weighted_rmse_normalizes_over_the_whole_batch():
    real, fake = fields(seed=12)
    whole = M.extreme_weighted_rmse(torch.from_numpy(real),
                                    torch.from_numpy(fake))
    first = M.extreme_weighted_rmse(torch.from_numpy(real[:1]),
                                    torch.from_numpy(fake[:1]))
    assert float(whole[0]) < float(first[0])
    zeros = torch.zeros(2, 1, 4, 4, 2)
    assert torch.equal(M.extreme_weighted_rmse(zeros, zeros + 1.0),
                       torch.zeros(2))


def test_encoded_features_l2_distance():
    rng = np.random.default_rng(13)
    a = rng.standard_normal((3, 4, 7), dtype=np.float32)
    b = rng.standard_normal((3, 4, 7), dtype=np.float32)
    b[1, 2, 3] = np.nan
    got = M.encoded_features_l2_distance(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    want = np.asarray(JM.encoded_features_l2_distance(jnp.asarray(a),
                                                      jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [1, 3, 8])
def test_box_mean(size):
    x = np.random.default_rng(14).standard_normal((2, 8, 11),
                                                  dtype=np.float32)
    got = M._box_mean(torch.from_numpy(x), size).numpy()
    want = np.asarray(JM._box_mean(jnp.asarray(x), size))
    assert got.shape == want.shape == (2, 8 - size + 1, 11 - size + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0, 0, 0], x[0, :size, :size].mean(),
                               atol=1e-5)


def test_all_generator_metrics_has_the_jax_names():
    assert sorted(M.ALL_GENERATOR_METRICS) == sorted(JM.ALL_GENERATOR_METRICS)
    real, fake = fields(seed=15)
    for name, fn in M.ALL_GENERATOR_METRICS.items():
        want = JM.ALL_GENERATOR_METRICS[name](jnp.asarray(real),
                                              jnp.asarray(fake))
        np.testing.assert_allclose(
            fn(torch.from_numpy(real), torch.from_numpy(fake)).numpy(),
            np.asarray(want), rtol=0, atol=1e-4, err_msg=name)


def test_spatial_ks_scalar_matches_jax():
    real, fake = fields(seed=16, shape=(1, 2, 20, 20, 2))
    got = M.spatial_ks_scalar(torch.from_numpy(real), torch.from_numpy(fake))
    want = JM.spatial_ks_scalar(jnp.asarray(real), jnp.asarray(fake),
                                use_pallas=False)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-5)
