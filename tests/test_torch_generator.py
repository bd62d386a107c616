"""The port's layers and generator (windtpu_torch/models) against the JAX
package's flax modules, on the same numpy weights carried to both sides by
windtpu_torch/weights.py.

f32 comparisons are tight: the same arithmetic, with only the convolutions'
summation order differing between XLA-CPU and ATen.  bf16 comparisons are
loose: flax rounds every op to bf16 (the JAX scan computes its gates in
bf16) while the port keeps the recurrence's gate math in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.models import layers as JL
from windtpu.models.generator import Generator as JGenerator
from windtpu.models.generator import init_generator as j_init_generator
from windtpu_torch.api import BUNDLED_GENERATOR
from windtpu_torch.core.config import ModelConfig
from windtpu_torch.models import layers as L
from windtpu_torch.models.generator import Generator, init_generator
from windtpu_torch.weights import (
    export_flax_variables,
    load_flax_variables,
    load_generator_npz,
)

torch.set_num_threads(2)


def flat_random(variables, seed):
    """The flax variable tree's leaves replaced by numpy draws (variances
    kept positive), as a '/'-keyed flat dict."""
    rng = np.random.RandomState(seed)
    flat = flatten_dict(jax.device_get(variables), sep="/")
    return {k: (np.abs(rng.standard_normal(np.shape(v))) + 0.5
                if k.endswith("/var")
                else 0.3 * rng.standard_normal(np.shape(v))
                ).astype(np.float32)
            for k, v in flat.items()}


def to_tree(flat):
    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def run_both(jmod, tmod, x, seed=0):
    flat = flat_random(jmod.init(jax.random.key(0), jnp.asarray(x)), seed)
    want = np.asarray(jmod.apply(to_tree(flat), jnp.asarray(x)))
    load_flax_variables(tmod, flat)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, want


def test_spectral_norm_one_power_step_off_stored_u():
    rng = np.random.RandomState(0)
    kernel = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    u = rng.standard_normal(7).astype(np.float32)
    want = JL.SpectralNorm(update_stats=False).apply(
        {"spectral_stats": {"u": jnp.asarray(u)}}, jnp.asarray(kernel))
    sn = L.SpectralNorm(7)
    sn.u.copy_(torch.from_numpy(u))
    got = sn(torch.from_numpy(kernel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(sn.u, torch.from_numpy(u))  # u is not updated


CONV_CASES = {
    # name: (in, out, kernel, strides, padding, spectral_norm, split)
    "int_pad_8x8_s2": (23, 16, (8, 8), (2, 2), 3, True, 0),
    "int_pad_split": (23, 16, (8, 8), (2, 2), 3, True, 3),
    "same_3x3": (12, 6, (3, 3), (1, 1), "SAME", True, 0),
    "same_4x4_s2_asymmetric": (6, 5, (4, 4), (2, 2), "SAME", True, 0),
    "valid_3x3": (6, 4, (3, 3), (1, 1), "VALID", True, 0),
    "same_plain_conv": (6, 2, (3, 3), (1, 1), "SAME", False, 0),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_time_conv(case):
    cin, cout, k, s, pad, sn, split = CONV_CASES[case]
    x = np.random.RandomState(1).standard_normal(
        (2, 3, 12, 12, cin)).astype(np.float32)
    jmod = JL.TimeConv(cout, k, strides=s, padding=pad,
                       use_spectral_norm=sn, update_sn_stats=False,
                       split_input_at=split)
    tmod = L.TimeConv(cin, cout, k, strides=s, padding=pad,
                      use_spectral_norm=sn, split_input_at=split)
    got, want = run_both(jmod, tmod, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geometry", ["up1_2x2_s2_valid_sn",
                                      "up2_5x5_same"])
def test_time_conv_transpose_keras_semantics(geometry):
    if geometry == "up1_2x2_s2_valid_sn":
        cin, cout, k, s, pad, sn = 12, 4, (2, 2), (2, 2), "VALID", True
    else:
        cin, cout, k, s, pad, sn = 10, 3, (5, 5), (1, 1), "SAME", False
    x = np.random.RandomState(2).standard_normal(
        (2, 2, 6, 6, cin)).astype(np.float32)
    jmod = JL.TimeConvTranspose(cout, k, strides=s, padding=pad,
                                use_spectral_norm=sn, update_sn_stats=False)
    tmod = L.TimeConvTranspose(cin, cout, k, strides=s, padding=pad,
                               use_spectral_norm=sn)
    got, want = run_both(jmod, tmod, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_time_batch_norm_inference():
    x = np.random.RandomState(3).standard_normal(
        (2, 3, 5, 5, 6)).astype(np.float32)
    got, want = run_both(JL.TimeBatchNorm(use_running_average=True),
                         L.TimeBatchNorm(6), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bilinear_upsample_half_pixel_centres():
    x = np.random.RandomState(4).standard_normal(
        (2, 3, 5, 7, 4)).astype(np.float32)
    want = np.asarray(JL.bilinear_upsample_2x(jnp.asarray(x)))
    got = L.bilinear_upsample_2x(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 10, 14, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bilinear_upsample_spreads_nan_over_its_plane_as_jax():
    """One NaN at one (b, t, c) makes that whole output plane NaN, as
    jax.image.resize's dense contraction does, and no other plane."""
    x = np.random.RandomState(5).standard_normal(
        (2, 3, 6, 8, 4)).astype(np.float32)
    x[1, 2, 4, 5, 3] = np.nan
    want = np.asarray(JL.bilinear_upsample_2x(jnp.asarray(x)))
    got = L.bilinear_upsample_2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 2, :, :, 3]).all()
    assert np.isnan(got).sum() == 12 * 16
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def _generator_pair(kw, flat, dtype):
    jcfg = JModelConfig(**kw, compute_dtype=dtype)
    tgen = Generator(ModelConfig(**kw, compute_dtype=dtype)).eval()
    load_flax_variables(tgen, flat)
    return JGenerator(jcfg), tgen


def _generator_inputs(kw, seed, batch=2):
    rng = np.random.RandomState(seed)
    t, i = kw["sequence_length"], kw["image_size"]
    img = rng.standard_normal((batch, t, i, i, 3)).astype(np.float32)
    noise = rng.standard_normal((batch, t, i, i, 20)).astype(np.float32)
    return img, noise


@pytest.mark.parametrize("features,dtype", [(16, "float32"),
                                            (16, "bfloat16"),
                                            (8, "float32")])
def test_tiny_generator_matches_flax(features, dtype):
    # F=16 takes the flagship's up2 (transpose-conv) head; F=8 has
    # F//8 < out_channels and takes the narrow up2_conv head.
    kw = dict(image_size=16, sequence_length=3, generator_features=features)
    flat = flat_random(j_init_generator(JModelConfig(**kw),
                                        jax.random.key(0)), seed=5)
    jgen, tgen = _generator_pair(kw, flat, dtype)
    assert tgen.wide_head == (features // 8 >= 2)
    img, noise = _generator_inputs(kw, seed=6)
    want = np.asarray(jgen.apply(to_tree(flat), img, noise, train=False))
    with torch.no_grad():
        got = tgen(torch.from_numpy(img), torch.from_numpy(noise)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 5e-2 * scale


def test_bundled_flagship_weights_match_flax():
    # The bundled weights' shapes depend only on F, the channels and the
    # kernel sizes, so the full-width F=128 generator runs here at 16 px
    # and T=3.
    kw = dict(image_size=16, sequence_length=3)
    with np.load(BUNDLED_GENERATOR) as data:
        flat = {k: data[k] for k in data.files}
    jgen, tgen = _generator_pair(kw, flat, "float32")
    img, noise = _generator_inputs(kw, seed=7)
    want = np.asarray(jgen.apply(to_tree(flat), img, noise, train=False))
    with torch.no_grad():
        got = tgen(torch.from_numpy(img), torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bundled_weights_carry_every_key():
    gen = init_generator(ModelConfig(), seed=0, device="cpu")
    load_generator_npz(BUNDLED_GENERATOR, gen)
    with np.load(BUNDLED_GENERATOR) as data:
        flat = {k: data[k] for k in data.files}
    state = gen.state_dict()
    assert len(state) == len(flat)
    for key, value in flat.items():
        tkey = key.split("/", 1)[1].replace("/", ".")
        assert torch.equal(state[tkey], torch.from_numpy(value)), key


@pytest.mark.parametrize("fault", ["missing", "extra", "shape",
                                   "collection"])
def test_weights_carry_rejects_mismatch(fault):
    with np.load(BUNDLED_GENERATOR) as data:
        flat = {k: data[k] for k in data.files}
    if fault == "missing":
        del flat["params/convlstm/recurrent_kernel"]
    elif fault == "extra":
        flat["params/convlstm/peephole"] = np.zeros(3, np.float32)
    elif fault == "shape":
        flat["params/mid/bias"] = np.zeros(63, np.float32)
    else:
        flat["batch_stats/mid/bias"] = flat.pop("params/mid/bias")
    with pytest.raises(ValueError):
        load_flax_variables(Generator(ModelConfig()), flat)


# ---- the training half of the layers ---------------------------------------

def test_spectral_norm_update_value_new_u_and_gradient():
    rng = np.random.RandomState(8)
    kernel = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    u = rng.standard_normal(7).astype(np.float32)
    g = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    jmod = JL.SpectralNorm(update_stats=True)
    variables = {"spectral_stats": {"u": jnp.asarray(u)}}

    def apply(k):
        out, mut = jmod.apply(variables, k, mutable=["spectral_stats"])
        return out, mut["spectral_stats"]["u"]

    (want, want_u), vjp = jax.vjp(apply, jnp.asarray(kernel))
    want_grad, = vjp((jnp.asarray(g), jnp.zeros(7)))

    sn = L.SpectralNorm(7)
    sn.u.copy_(torch.from_numpy(u))
    tk = torch.from_numpy(kernel).requires_grad_()
    got = sn(tk, update_stats=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sn.u.numpy(), np.asarray(want_u), rtol=0,
                               atol=1e-6)
    assert not sn.u.requires_grad
    # The power step carries no gradient: sigma is differentiable through
    # the kernel alone, as with the JAX layer's stop_gradient.
    got_grad, = torch.autograd.grad(got, tk, torch.from_numpy(g))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-5)
    # A second call starts from the updated u.
    again = sn(tk, update_stats=True)
    assert not torch.equal(again, got)


def test_spectral_norm_update_between_two_uses_keeps_the_double_backward():
    sn = L.SpectralNorm(4)
    sn.u.copy_(torch.randn(4, generator=torch.Generator().manual_seed(0)))
    k = torch.randn(3, 3, 2, 4, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    x = torch.randn(5, requires_grad=True)
    first = (sn(k, update_stats=True).sum() * x).sum()
    gx, = torch.autograd.grad(first, x, create_graph=True)
    second = sn(k, update_stats=True).sum()     # overwrites u in between
    (gx.pow(2).sum() + second).backward()
    assert torch.isfinite(k.grad).all() and float(k.grad.abs().max()) > 0


def test_time_batch_norm_training_twice_in_a_row():
    rng = np.random.RandomState(9)
    jmod = JL.TimeBatchNorm(use_running_average=False)
    x0 = rng.standard_normal((2, 3, 5, 5, 6)).astype(np.float32)
    flat = flat_random(jmod.init(jax.random.key(0), jnp.asarray(x0)), 10)
    tmod = load_flax_variables(L.TimeBatchNorm(6), flat)
    variables = to_tree(flat)
    for i in range(2):
        x = (2.0 * rng.standard_normal((2, 3, 5, 5, 6)) + 1.0).astype(
            np.float32)
        g = rng.standard_normal(x.shape).astype(np.float32)

        def apply(params, inp):
            return jmod.apply({**variables, "params": params}, inp,
                              mutable=["batch_stats"])

        (want, mut), vjp = jax.vjp(apply, variables["params"],
                                   jnp.asarray(x))
        zeros = jax.tree_util.tree_map(jnp.zeros_like, mut)
        want_dp, want_dx = vjp((jnp.asarray(g), zeros))
        variables = {**variables, **mut}

        tx = torch.from_numpy(x).requires_grad_()
        got = tmod(tx, train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        # Running statistics: biased variance, ra = 0.99 ra + 0.01 batch.
        stats = flatten_dict(jax.device_get(mut), sep="/")
        after = export_flax_variables(tmod)
        for k, v in stats.items():
            np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{k} after call {i}")
        # The gradient flows through the batch statistics.
        dx, dscale, dbias = torch.autograd.grad(
            got, (tx, tmod.bn.scale, tmod.bn.bias), torch.from_numpy(g))
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dscale.numpy(),
                                   np.asarray(want_dp["bn"]["scale"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dbias.numpy(),
                                   np.asarray(want_dp["bn"]["bias"]),
                                   rtol=1e-4, atol=1e-4)
    # Inference afterwards reads the moved statistics.
    x = rng.standard_normal((2, 3, 5, 5, 6)).astype(np.float32)
    want = JL.TimeBatchNorm(use_running_average=True).apply(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_keras_layer_norm():
    x = (3.0 * np.random.RandomState(11).standard_normal(
        (2, 3, 4, 5, 6))).astype(np.float32)
    got, want = run_both(JL.KerasLayerNorm(), L.KerasLayerNorm(6), x,
                         seed=12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_time_dense():
    x = np.random.RandomState(13).standard_normal((2, 3, 10)).astype(
        np.float32)
    got, want = run_both(JL.TimeDense(4), L.TimeDense(10, 4), x, seed=14)
    assert got.shape == (2, 3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_size,target", [(9, 2), (31, 2), (7, 1),
                                            (40, 5)])
def test_shortcut_conv(in_size, target):
    assert (L.shortcut_geometry(in_size, target)
            == JL.shortcut_geometry(in_size, target))
    x = np.random.RandomState(15).standard_normal(
        (2, 2, in_size, in_size, 3)).astype(np.float32)
    jmod = JL.ShortcutConv(target_size=target, features=5,
                           update_sn_stats=False)
    tmod = L.ShortcutConv(3, 5, in_size=in_size, target_size=target)
    got, want = run_both(jmod, tmod, x, seed=16)
    assert got.shape == want.shape == (2, 2, target, target, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tiny_generator_training_forward_matches_flax():
    kw = dict(image_size=16, sequence_length=3, generator_features=16)
    flat = flat_random(j_init_generator(JModelConfig(**kw),
                                        jax.random.key(0)), seed=17)
    jgen, tgen = _generator_pair(kw, flat, "float32")
    variables = to_tree(flat)
    for i in range(2):
        img, noise = _generator_inputs(kw, seed=18 + i)
        want, mut = jgen.apply(variables, img, noise, train=True,
                               mutable=["batch_stats", "spectral_stats"])
        variables = {**variables, **mut}
        got = tgen(torch.from_numpy(img), torch.from_numpy(noise),
                   train=True)
        assert got.requires_grad
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        after = export_flax_variables(tgen)
        moved = flatten_dict(jax.device_get(mut), sep="/")
        assert len(moved) == 5 * 2 + 4     # five BatchNorms, four SN convs
        for k, v in moved.items():
            np.testing.assert_allclose(after[k], v, rtol=0, atol=1e-5,
                                       err_msg=f"{k} after call {i}")
            assert not np.array_equal(after[k], flat[k]), k
