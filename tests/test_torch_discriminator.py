"""The port's critic (windtpu_torch/models/discriminator.py) and its layers
against the JAX package's flax modules, on the same numpy weights carried to
both sides by windtpu_torch/weights.py: scores with train=False and
train=True, the advanced spectral-norm vectors, and the gradient penalty,
which differentiates the critic twice.  f32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.models.discriminator import Discriminator as JDiscriminator
from windtpu.models.discriminator import _pyramid_sizes as j_pyramid_sizes
from windtpu.models.discriminator import init_discriminator as j_init
from windtpu.train.losses import gradient_penalty_from_grads as j_gp
from windtpu_torch.core.config import ModelConfig
from windtpu_torch.models import layers as L
from windtpu_torch.models.discriminator import (
    Discriminator,
    _pyramid_sizes,
    init_discriminator,
)
from windtpu_torch.train.losses import gradient_penalty
from windtpu_torch.weights import export_flax_variables, load_flax_variables

torch.set_num_threads(2)

# TINY is the config of tests/test_train.py.  At 32 px with
# discriminator_shortcut_min_iters=1 the second pyramid's one stage (9 -> 2
# px) gets the strided shortcut residual, a 6x6 conv of stride 11.
CONFIGS = {
    "tiny_24px": dict(image_size=24, noise_channels=2, sequence_length=2,
                      generator_features=16, discriminator_features=4),
    "shortcut_32px": dict(image_size=32, noise_channels=2, sequence_length=2,
                          generator_features=16, discriminator_features=2,
                          discriminator_shortcut_min_iters=1),
    "fused_branches_24px": dict(image_size=24, noise_channels=2,
                                sequence_length=3, generator_features=16,
                                discriminator_features=4,
                                critic_fused_branches=True),
}


def flat_random(variables, seed):
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables), sep="/")
    return {k: (np.asarray(v) + 0.2 * rng.standard_normal(np.shape(v))
                ).astype(np.float32) for k, v in flat.items()}


def to_tree(flat):
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def critic_pair(name, seed=0):
    kw = CONFIGS[name]
    jcfg = JModelConfig(**kw)
    flat = flat_random(j_init(jcfg, jax.random.key(0)), seed)
    tmod = load_flax_variables(Discriminator(ModelConfig(**kw)), flat)
    return JDiscriminator(jcfg), tmod, flat, kw


def images(kw, seed, b=2):
    rng = np.random.default_rng(seed)
    shape = (b, kw["sequence_length"], kw["image_size"], kw["image_size"])
    return (rng.standard_normal(shape + (3,), dtype=np.float32),
            rng.standard_normal(shape + (2,), dtype=np.float32))


@pytest.mark.parametrize("size", [24, 32, 64, 96, 128])
def test_pyramid_sizes_equal(size):
    assert _pyramid_sizes(size) == j_pyramid_sizes(size)


def test_pyramid_collapse_raises():
    with pytest.raises(ValueError, match="pyramid collapses"):
        _pyramid_sizes(16)
    with pytest.raises(ValueError, match="pyramid collapses"):
        Discriminator(ModelConfig(image_size=16))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_critic_scores_and_spectral_vectors_match_flax(name):
    jmod, tmod, flat, kw = critic_pair(name)
    assert tmod.has_shortcut == (name == "shortcut_32px")
    if tmod.has_shortcut:
        assert tuple(tmod.shortcut.conv.kernel.shape[:2]) == (6, 6)
    low_res, high_res = images(kw, seed=1)
    variables = to_tree(flat)
    want = np.asarray(jmod.apply(variables, low_res, high_res, train=False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(low_res), torch.from_numpy(high_res))
    assert got.shape == (2, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert {k: v for k, v in export_flax_variables(tmod).items()
            if k.startswith("spectral")}.keys() == {
                k for k in flat if k.startswith("spectral")}
    for k, v in export_flax_variables(tmod).items():
        np.testing.assert_array_equal(v, flat[k])   # train=False moves none

    want, mutated = jmod.apply(variables, low_res, high_res, train=True,
                               mutable=["spectral_stats"])
    with torch.no_grad():
        got = tmod(torch.from_numpy(low_res), torch.from_numpy(high_res),
                   train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    new_u = flatten_dict(jax.device_get(mutated), sep="/")
    after = export_flax_variables(tmod)
    assert len(new_u) > 3
    for k, v in new_u.items():
        np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
        assert not np.array_equal(after[k], flat[k]), k


@pytest.mark.parametrize("name", ["tiny_24px", "shortcut_32px"])
def test_gradient_penalty_double_backward_matches_jax(name):
    jmod, tmod, flat, kw = critic_pair(name, seed=3)
    low_res, high_res = images(kw, seed=4)
    _, fake = images(kw, seed=5)
    eps = np.random.default_rng(6).random((2, 1, 1, 1, 1), dtype=np.float32)
    spectral = to_tree({k: v for k, v in flat.items()
                        if k.startswith("spectral")})["spectral_stats"]
    params = to_tree({k: v for k, v in flat.items()
                      if k.startswith("params")})["params"]
    mixed = eps * high_res + (1.0 - eps) * fake

    def penalty_of(p):
        def critic_on_image(x):
            return jnp.sum(jmod.apply(
                {"params": p, "spectral_stats": spectral}, low_res, x,
                train=False))
        return j_gp(jax.grad(critic_on_image)(mixed), 100.0)

    (want_pen, want_norm), want_grads = jax.value_and_grad(
        penalty_of, has_aux=True)(params)
    want_grads = flatten_dict(jax.device_get(want_grads), sep="/")

    pen, norm = gradient_penalty(
        lambda x: tmod(torch.from_numpy(low_res), x),
        torch.from_numpy(high_res), torch.from_numpy(fake),
        torch.from_numpy(eps), gamma=100.0)
    np.testing.assert_allclose(pen.item(), float(want_pen), rtol=1e-3)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-3)
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(pen, list(tmod.parameters()),
                                allow_unused=True)
    checked = 0
    for n, g in zip(names, grads):
        want = want_grads[n.replace(".", "/")]
        if g is None:
            # Parameters after the last nonlinearity shift the score and
            # leave its image gradient alone.
            np.testing.assert_array_equal(want, 0.0)
            continue
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-3 * scale, err_msg=n)
        checked += 1
    assert checked >= len(names) - 3


def test_fused_dual_convlstm_equals_the_two_layers():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 7, 5),
                                             dtype=np.float32))
    a = L.init_variables(L.ConvLSTM(2, 2, recurrence=L.convlstm_scan), 1)
    b = L.init_variables(L.ConvLSTM(5, 4, recurrence=L.convlstm_scan), 2)
    with torch.no_grad():
        for m in (a, b):   # move the zero-initialised biases
            m.input_conv.bias.add_(0.1 * torch.randn(m.input_conv.bias.shape))
        want_a, want_b = a(x[..., 3:5]), b(x)
        got_a, got_b = L.fused_dual_convlstm(x, (3, 5), (0, 5), a.tensors(),
                                             b.tensors())
    assert got_a.shape == (2, 3, 6, 7, 2) and got_b.shape == (2, 3, 6, 7, 4)
    torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_b, want_b, rtol=1e-5, atol=1e-6)


def test_critic_layers_run_the_scan_and_the_generator_the_kernel_wrapper():
    from windtpu_torch.models.generator import Generator
    from windtpu_torch.ops.convlstm import convlstm_seq

    critic = Discriminator(ModelConfig(**CONFIGS["tiny_24px"]))
    assert critic.hr_convlstm.recurrence is L.convlstm_scan
    assert critic.mix_convlstm.recurrence is L.convlstm_scan
    gen = Generator(ModelConfig(**CONFIGS["tiny_24px"]))
    assert gen.convlstm.recurrence is convlstm_seq


def test_init_discriminator_uses_keras_initialisers_by_name():
    cfg = ModelConfig(**CONFIGS["tiny_24px"])
    a = init_discriminator(cfg, seed=3, device="cpu")
    b = init_discriminator(cfg, seed=3, device="cpu")
    c = init_discriminator(cfg, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["hr_conv.kernel"], sc["hr_conv.kernel"])
    rk = sa["mix_convlstm.recurrent_kernel"].reshape(-1, 16)   # (36, 16)
    torch.testing.assert_close(rk.T @ rk, torch.eye(16), atol=1e-5, rtol=0)
    k = sa["pyr1_conv_24.kernel"]
    lim = (6.0 / (7 * 7 * 8 + 7 * 7 * 16)) ** 0.5
    assert float(k.abs().max()) <= lim and float(k.abs().max()) > 0.9 * lim
    assert torch.equal(sa["mix_convlstm.forget_bias"], torch.ones(4))
    assert torch.equal(sa["hr_ln.ln.scale"], torch.ones(4))
    assert torch.equal(sa["score_dense.dense.bias"], torch.zeros(1))
    assert float(sa["hr_conv.sn.u"].std()) > 0.1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import unittest.mock as mock
        with mock.patch.object(torch.cuda, "is_available", lambda: False):
            init_discriminator(cfg)


def test_critic_rejects_other_image_sizes_and_mismatched_inputs():
    critic = init_discriminator(ModelConfig(**CONFIGS["tiny_24px"]), 0,
                                "cpu")
    with pytest.raises(ValueError, match="built for 24 px"):
        critic(torch.zeros(1, 2, 32, 32, 3), torch.zeros(1, 2, 32, 32, 2))
    with pytest.raises(ValueError, match="must share"):
        critic(torch.zeros(1, 2, 12, 12, 3), torch.zeros(1, 2, 24, 24, 2))
