"""The port's single-device tiled predictor
(windtpu_torch/infer/engine.py:make_tiled_predictor) against
windtpu.infer.engine.make_tiled_predictor.

Noise cannot be reproduced across frameworks, so the comparisons run at
noise_std=0.  The field carries NaN holes and the tiling is ragged in
space and time, with a padded last patch group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from windtpu.core.config import InferenceConfig as JInferenceConfig
from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.infer import engine as jengine
from windtpu.infer.tiling import plan_tiling as j_plan_tiling
from windtpu.models.generator import init_generator as j_init_generator
from windtpu_torch.core.config import InferenceConfig, ModelConfig
from windtpu_torch.infer import engine
from windtpu_torch.infer.tiling import plan_tiling
from windtpu_torch.models.generator import Generator
from windtpu_torch.weights import load_flax_variables

torch.set_num_threads(2)

MODEL = dict(image_size=16, sequence_length=3, generator_features=16)
INFER = dict(sequence_length=3, image_size=16, noise_std=0.0,
             overlap_factor=0.3, group_size=3)


def _field(seed=0, t=7, h=37, w=45):
    rng = np.random.RandomState(seed)
    field = rng.standard_normal((t, h, w, 3)).astype(np.float32)
    field[..., 0] += 3.0
    field[2, 5:9, 10:14, 0] = np.nan    # holes in one channel
    field[4:6, 30:33, 2:4, :] = np.nan  # and in all channels
    return field


def _plans(field, icfg):
    t, h, w, _ = field.shape
    args = (h, w, t, icfg["image_size"], icfg["sequence_length"],
            icfg["overlap_factor"])
    return j_plan_tiling(*args), plan_tiling(*args)


@pytest.mark.parametrize("quirk", [True, False])
def test_stitch_and_statistics_match_with_injected_network(quirk):
    # apply_fn stands in for the network so the tiling, normalization,
    # lat reversal, crop and stitch are compared on their own.
    icfg = dict(INFER, replicate_normalization_quirk=quirk)
    field = _field()
    jplan, tplan = _plans(field, icfg)
    jpred, jcounts = jengine.make_tiled_predictor(
        JModelConfig(**MODEL), JInferenceConfig(**icfg), jplan,
        apply_fn=lambda v, x, n: x[..., :2] * (1.0 + x[..., 2:3]))(
            None, jnp.asarray(field), jax.random.key(0))
    tpred, tcounts = engine.make_tiled_predictor(
        ModelConfig(**MODEL), InferenceConfig(**icfg), tplan,
        lambda x, n: x[..., :2] * (1.0 + x[..., 2:3]), "cpu")(
            torch.from_numpy(field), torch.Generator())
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    jpred = np.asarray(jpred)
    tpred = tpred.numpy()
    np.testing.assert_array_equal(np.isnan(tpred), np.isnan(jpred))
    np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


def test_generator_predictor_matches_jax():
    rng = np.random.RandomState(3)
    jv = j_init_generator(JModelConfig(**MODEL), jax.random.key(0))
    flat = {k: (np.abs(v) + 0.5 if k.endswith("/var")
                else np.asarray(v) + 0.05 * rng.standard_normal(np.shape(v))
                ).astype(np.float32)
            for k, v in flatten_dict(jv, sep="/").items()}
    g_vars = unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                            sep="/")
    field = _field(seed=1)
    jplan, tplan = _plans(field, INFER)
    assert tplan.num_patches % INFER["group_size"]  # a padded last group
    jpred, _ = jengine.make_tiled_predictor(
        JModelConfig(**MODEL), JInferenceConfig(**INFER), jplan)(
            g_vars, jnp.asarray(field), jax.random.key(0))
    gen = Generator(ModelConfig(**MODEL)).eval()
    load_flax_variables(gen, flat)
    tpred, _ = engine.make_tiled_predictor(
        ModelConfig(**MODEL), InferenceConfig(**INFER), tplan, gen, "cpu")(
            torch.from_numpy(field), torch.Generator())
    jpred, tpred = np.asarray(jpred), tpred.numpy()
    np.testing.assert_array_equal(np.isnan(tpred), np.isnan(jpred))
    assert np.isfinite(tpred).any()
    # f32 end to end; conv summation order differs between XLA and ATen.
    np.testing.assert_allclose(tpred, jpred, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


def test_coverage_counts_and_grouping_match():
    for h, w, t, overlap, group in [(37, 45, 7, 0.3, 4), (96, 130, 24, 0.05,
                                                          16)]:
        jplan = j_plan_tiling(h, w, t, 16, 3, overlap)
        tplan = plan_tiling(h, w, t, 16, 3, overlap)
        jo, jw = jengine._grouped_origins(jplan, group)
        to, tw = engine._grouped_origins(tplan, group)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(
            engine._coverage_counts(tplan, to, tw, 2),
            jengine._coverage_counts(jplan, jo, jw, 2))


def test_noise_is_drawn_per_group_from_the_callers_generator():
    field = np.nan_to_num(_field(seed=2))
    _, tplan = _plans(field, INFER)
    icfg = InferenceConfig(**dict(INFER, noise_std=1.0))
    seen = []

    def apply_fn(x, n):
        seen.append(n.clone())
        return x[..., :2]

    predictor = engine.make_tiled_predictor(ModelConfig(**MODEL), icfg, tplan,
                                      apply_fn, "cpu")
    predictor(torch.from_numpy(field), torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = [torch.randn(n.shape, generator=gen) for n in seen]
    assert len(seen) == -(-tplan.num_patches // INFER["group_size"])
    for got, exp in zip(seen, want):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
