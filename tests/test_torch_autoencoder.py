"""The port's autoencoder, perceptual features and reconstruction loss
(windtpu_torch/models/autoencoder.py, features.py, train/losses.py) against
windtpu's, and one train step with the reconstruction loss on.

Both sides carry the same weights: the bundled autoencoder-synth.npz at
the flagship geometry (96 px), random flax weights carried across at the
tiny training config's 24 px.  f32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tests.test_torch_train import (
    assert_metrics_close,
    assert_states_close,
    batch,
    configs,
    jax_draws,
)
from windtpu.models import autoencoder as jae
from windtpu.train import create_train_state as j_create_train_state
from windtpu.train import make_train_step as j_make_train_step
from windtpu.train.checkpoint import load_generator_npz, save_generator_npz
from windtpu.train.losses import reconstruction_loss as j_reconstruction_loss
from windtpu_torch import features
from windtpu_torch.models import autoencoder as tae
from windtpu_torch.train.losses import reconstruction_loss
from windtpu_torch.train.state import create_train_state
from windtpu_torch.train.wgan_gp import make_train_step
from windtpu_torch.weights import (
    export_train_state,
    load_autoencoder_npz,
    load_train_state,
)

torch.set_num_threads(2)


def _field(seed, shape):
    return (3.0 * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32))


def _jax_autoencoder(image_size, latent, weights=None, seed=0):
    """(flax model, variables as numpy), from ``weights`` (an npz) or
    random: scales and variances in [0.5, 1.5), the rest N(0, 0.2^2)."""
    model = jae.AutoEncoder(image_size=image_size, time_steps=2,
                            latent_dimension=latent)
    # The variables' shapes without running flax's initializers.
    shapes = jax.eval_shape(
        lambda key, x: model.init(key, x, train=False), jax.random.key(seed),
        jnp.zeros((1, 2, image_size, image_size, 2)))
    if weights is not None:
        return model, load_generator_npz(weights, shapes)
    rng = np.random.default_rng(seed)
    flat = {k: (0.5 + rng.random(v.shape) if k.endswith(("/var", "/scale"))
                else 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten_dict(shapes, sep="/").items()}
    return model, unflatten_dict(flat, sep="/")


@pytest.fixture(scope="module")
def bundled():
    """(flax model, variables, the port's AutoEncoder) with the bundled
    weights at 96 px."""
    model, variables = _jax_autoencoder(96, 96, features.BUNDLED_AUTOENCODER)
    port = tae.AutoEncoder(96, 2, 96)
    load_autoencoder_npz(features.BUNDLED_AUTOENCODER, port)
    return model, variables, port.eval()


@pytest.mark.parametrize("size", [24, 48, 96, 100])
def test_encoder_pyramid_sizes_match(size):
    assert tae._encoder_sizes(size) == jae._encoder_sizes(size)


def test_bundled_autoencoder_matches_jax(bundled):
    model, variables, port = bundled
    x = _field(1, (1, 2, 96, 96, 2))
    want_z = np.asarray(model.apply(variables, x, train=False,
                                    method=jae.AutoEncoder.encode))
    want_y = np.asarray(model.apply(variables, x, train=False))
    with torch.no_grad():
        got_z = port.encode(torch.from_numpy(x)).numpy()
        got_y = port(torch.from_numpy(x)).numpy()
    assert got_z.shape == (1, 2, 96) and got_y.shape == x.shape
    np.testing.assert_allclose(got_z, want_z, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tae.weighted_vector_loss(torch.from_numpy(x),
                                 torch.from_numpy(got_y)).numpy(),
        np.asarray(jae.weighted_vector_loss(x, want_y)), rtol=1e-4,
        atol=1e-4)


def test_load_autoencoder_npz_takes_variables_and_rejects_mismatch(bundled):
    _, variables, port = bundled
    other = tae.AutoEncoder(96, 2, 96)
    load_autoencoder_npz(variables, other)     # nested numpy variables
    for a, b in zip(port.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    flat = flatten_dict(variables, sep="/")
    for fault in ("missing", "extra", "shape"):
        bad = dict(flat)
        if fault == "missing":
            del bad["spectral_stats/encoder/conv_96/sn/u"]
        elif fault == "extra":
            bad["params/encoder/middle/dense/bias"] = np.zeros(3, np.float32)
        else:
            bad["params/encoder/latent/dense/bias"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError):
            load_autoencoder_npz(bad, tae.AutoEncoder(96, 2, 96))
    with pytest.raises(ValueError):            # another geometry
        load_autoencoder_npz(features.BUNDLED_AUTOENCODER,
                             tae.AutoEncoder(48, 2, 96))


@pytest.fixture
def checkpoint_root(tmp_path, monkeypatch):
    monkeypatch.setenv("CHECKPOINT_ROOT", str(tmp_path))
    features._cache.clear()
    yield tmp_path / "autoencoder"
    features._cache.clear()


def test_encoder_fn_takes_the_newest_npz_checkpoint(checkpoint_root, capsys):
    model, variables = _jax_autoencoder(24, 24, seed=1)
    _, older = _jax_autoencoder(24, 24, seed=2)
    checkpoint_root.mkdir()
    save_generator_npz(checkpoint_root / "step_3.npz", older)
    save_generator_npz(checkpoint_root / "step_12.npz", variables)
    enc = features.get_encoder_fn(24, 2, 24, device="cpu")
    assert enc.source == str(checkpoint_root / "step_12.npz")
    assert "warning" not in capsys.readouterr().out
    assert features.get_encoder_fn(24, 2, 24, device="cpu") is enc
    x = _field(2, (2, 2, 24, 24, 2))
    want = np.asarray(model.apply(variables, x, train=False,
                                  method=jae.AutoEncoder.encode))
    # Frozen parameters; the gradient reaches the input.
    xt = torch.from_numpy(x).requires_grad_()
    z = enc(xt)
    z.sum().backward()
    assert xt.grad is not None and float(xt.grad.abs().max()) > 0
    np.testing.assert_allclose(z.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_encoder_fn_falls_back_to_the_bundled_weights(checkpoint_root,
                                                      bundled, capsys):
    model, variables, _ = bundled
    enc = features.get_encoder_fn(96, 2, 96, device="cpu")
    assert enc.source == str(features.BUNDLED_AUTOENCODER)
    assert "warning" not in capsys.readouterr().out
    x = _field(3, (1, 2, 96, 96, 2))
    want = np.asarray(model.apply(variables, x, train=False,
                                  method=jae.AutoEncoder.encode))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_encoder_fn_warns_into_random_weights(checkpoint_root, capsys):
    enc = features.get_encoder_fn(48, 2, 48, device="cpu")
    out = capsys.readouterr().out
    assert enc.source == "random"
    assert ("warning: no autoencoder checkpoint at "
            f"{checkpoint_root} and no matching bundled weights") in out
    assert enc(torch.zeros(1, 2, 48, 48, 2)).shape == (1, 2, 48)


def test_encoder_fn_refuses_an_orbax_checkpoint(checkpoint_root):
    _, variables = _jax_autoencoder(24, 24, seed=1)
    checkpoint_root.mkdir()
    save_generator_npz(checkpoint_root / "step_3.npz", variables)
    (checkpoint_root / "step_7").mkdir()           # orbax's layout
    with pytest.raises(ValueError, match="save_generator_npz"):
        features.get_encoder_fn(24, 2, 24, device="cpu")


def test_reconstruction_loss_matches_jax(bundled):
    model, variables, port = bundled
    low = _field(4, (2, 2, 96, 96, 2))
    high = _field(5, (2, 2, 96, 96, 2))
    want = j_reconstruction_loss(
        lambda x: model.apply(variables, x, train=False,
                              method=jae.AutoEncoder.encode), 0.7)(low, high)
    with torch.no_grad():
        got = reconstruction_loss(port.encode, 0.7)(torch.from_numpy(low),
                                                    torch.from_numpy(high))
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def _jax_state(jcfg, flat):
    """The JAX package's GANTrainState holding the flat state ``flat``
    (weights.export_train_state's layout), built on the state's abstract
    shapes instead of flax's initializers, which take tens of seconds
    here."""
    shapes = jax.eval_shape(lambda: j_create_train_state(jcfg))

    def key(path):
        parts = []
        for p in path:
            if isinstance(p, jax.tree_util.GetAttrKey):
                parts.append(p.name.replace("_opt_state", "_opt"))
            elif isinstance(p, jax.tree_util.DictKey):
                parts.append(str(p.key))
        return "/".join(parts)

    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(flat[key(path)], leaf.dtype) for path, leaf in leaves])


def test_train_step_with_reconstruction_loss_matches_jax():
    """One WGAN-GP step with reconstruction_coefficient 1.0, from the same
    state, batch, draws and encoder weights, at the tolerances of
    tests/test_torch_train.py."""
    jcfg, tcfg = configs(reconstruction_coefficient=1.0, n_critic=1,
                         compute_metrics=False)
    model, variables = _jax_autoencoder(24, 24, seed=3)
    port = tae.AutoEncoder(24, 2, 24)
    load_autoencoder_npz(variables, port)
    port.eval().requires_grad_(False)
    rng = np.random.default_rng(4)

    def moved(key, value):
        """Parameters and statistics off their initial values (biases and
        BatchNorm statistics are 0 and 1 there)."""
        if "_opt/" in key or key == "step":
            return value
        value = value + 0.05 * rng.standard_normal(value.shape)
        if key.endswith("/var"):
            value = np.abs(value) + 0.1
        return value.astype(np.float32)

    flat = {k: moved(k, v) for k, v in export_train_state(
        create_train_state(tcfg, device="cpu")).items()}
    tstate = load_train_state(create_train_state(tcfg, device="cpu"), flat)
    jstate = _jax_state(jcfg, flat)
    assert_states_close(tstate, jstate, atol=0)
    jstep = j_make_train_step(jcfg, feature_fn=lambda x: model.apply(
        variables, x, train=False, method=jae.AutoEncoder.encode))
    tstep = make_train_step(tcfg, feature_fn=port.encode)
    key = jax.random.key(6)
    low_res, high_res = batch(seed=80)
    draws = jax_draws(jcfg, key, 0, low_res, high_res)
    jstate, want = jstep(jstate, low_res, high_res, key)
    tstate, got = tstep(tstate, low_res, high_res, draws=draws)
    assert float(got["g_reco_loss"]) > 0
    assert_metrics_close(got, want)
    assert_states_close(tstate, jstate, atol=1e-4)
    # Without an encoder the coefficient is inert, as in the JAX step.
    _, off = make_train_step(tcfg)(tstate, low_res, high_res, draws=draws)
    assert float(off["g_reco_loss"]) == 0.0
