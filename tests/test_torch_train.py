"""The port's training slice (windtpu_torch/train, network.py) against the
JAX package's, as a whole: from the same carried state, the same batch and
the same random draws, two consecutive WGAN-GP steps and one eval step give
the same metrics and the same updated parameters, BatchNorm statistics,
spectral-norm vectors and Adam moments.

The draws are built from JAX's own key derivations inside its step
(fold_in(rng, step), fold_in(.., critic_iter), split(k, 4),
fold_in(.., 1000), fold_in(.., 2000)) and handed to the port's step, which
takes its draws as an argument.  Everything is f32 at the TINY config of
tests/test_train.py, with compute_spatial_ks on.  Each rematerialisation
mode matches the JAX step with that mode, and writes the forward state
once: its state and gradients equal the port's remat=False step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from windtpu.core.config import GANConfig as JGANConfig
from windtpu.core.config import ModelConfig as JModelConfig
from windtpu.core.config import TrainConfig as JTrainConfig
from windtpu.models.generator import Generator as JGenerator
from windtpu.train import checkpoint as jckpt
from windtpu.train import create_train_state as j_create_train_state
from windtpu.train import make_eval_step as j_make_eval_step
from windtpu.train import make_train_step as j_make_train_step
from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
from windtpu_torch.network import WindDownscalingGAN
from windtpu_torch.train import checkpoint as ckpt
from windtpu_torch.train import loop
from windtpu_torch.train.optim import Adam, RMSprop
from windtpu_torch.train.state import create_train_state
from windtpu_torch.train.wgan_gp import (
    CriticDraws,
    StepDraws,
    _critic_inputs,
    critic_graph,
    critic_graph_key,
    draw_step_noise,
    make_eval_step,
    make_train_step,
)
from windtpu_torch.weights import export_train_state, load_train_state

torch.set_num_threads(2)

MODEL = dict(image_size=24, in_channels=3, noise_channels=2, out_channels=2,
             sequence_length=2, generator_features=16,
             discriminator_features=4)
TRAIN = dict(batch_size=2, n_critic=2, compute_spatial_ks=True)
VARIANTS = {
    "default": {},
    "detach_gp": {"detach_gp": True},
    "unfused_scoring": {"fused_scoring": False},
    "no_adversary": {"adversarial_coefficient": 0.0, "n_critic": 0,
                     "sharpness_coefficient": 0.5},
}
_STATE_FIELDS = ("g_params", "g_batch_stats", "g_spectral", "d_params",
                 "d_spectral")


def configs(**train_kw):
    kw = {**TRAIN, **train_kw}
    return (JGANConfig(model=JModelConfig(**MODEL), train=JTrainConfig(**kw)),
            GANConfig(model=ModelConfig(**MODEL), train=TrainConfig(**kw)))


def flatten_state(state):
    """A JAX GANTrainState as the flat numpy dict the port's
    load_train_state reads."""
    flat = {"step": np.asarray(state.step)}
    for field in _STATE_FIELDS:
        for k, v in flatten_dict(getattr(state, field), sep="/").items():
            flat[f"{field}/{k}"] = np.asarray(v)
    for name, opt in (("g_opt", state.g_opt_state),
                      ("d_opt", state.d_opt_state)):
        adam = opt[0]
        flat[f"{name}/count"] = np.asarray(adam.count)
        for slot in ("mu", "nu"):
            for k, v in flatten_dict(getattr(adam, slot), sep="/").items():
                flat[f"{name}/{slot}/{k}"] = np.asarray(v)
    return flat


def perturbed_state(jcfg, seed):
    """A fresh JAX state whose leaves are moved off their initial values
    (biases, BatchNorm statistics and scales are otherwise 0 and 1)."""
    rng = np.random.default_rng(seed)
    state = j_create_train_state(jcfg)

    def move(tree, positive=False):
        flat = flatten_dict(jax.device_get(tree), sep="/")
        out = {}
        for k, v in flat.items():
            noise = 0.05 * rng.standard_normal(np.shape(v))
            new = (np.abs(np.asarray(v) + noise) + 0.1
                   if k.endswith("/var") else np.asarray(v) + noise)
            out[k] = jnp.asarray(new.astype(np.float32))
        return unflatten_dict(out, sep="/")

    return state.replace(**{f: move(getattr(state, f))
                            for f in _STATE_FIELDS})


def batch(seed, b=2):
    rng = np.random.default_rng(seed)
    shape = (b, MODEL["sequence_length"], MODEL["image_size"],
             MODEL["image_size"])
    low_res = rng.standard_normal(shape + (3,), dtype=np.float32)
    high_res = 3.0 * rng.standard_normal(shape + (2,), dtype=np.float32)
    return low_res, high_res


def jax_draws(jcfg, rng, step, low_res, high_res) -> StepDraws:
    """The random numbers the JAX step derives from (rng, step), as the
    port's StepDraws; ``step=None`` takes ``rng`` as already folded."""
    def t(x):
        return torch.from_numpy(np.array(x))

    b, tt, h, w = low_res.shape[:4]
    noise_shape = (b, tt, h, w, jcfg.model.noise_channels)
    inst_shape = (b, tt, h, w, high_res.shape[-1])
    if step is not None:
        rng = jax.random.fold_in(rng, step)
    critic = []
    for it in range(jcfg.train.n_critic):
        k_noise, k_eps, k_ir, k_if = jax.random.split(
            jax.random.fold_in(rng, it), 4)
        critic.append(CriticDraws(
            noise=t(jax.random.normal(k_noise, noise_shape)),
            eps=t(jax.random.uniform(k_eps, (b, 1, 1, 1, 1))),
            inst_real=t(jax.random.normal(k_ir, inst_shape)),
            inst_fake=t(jax.random.normal(k_if, inst_shape))))
    return StepDraws(
        critic=critic,
        gen_noise=t(jax.random.normal(jax.random.fold_in(rng, 1000),
                                      noise_shape)),
        eval_noise=t(jax.random.normal(jax.random.fold_in(rng, 2000),
                                       noise_shape)))


def assert_states_close(tstate, jstate, atol):
    got, want = export_train_state(tstate), flatten_state(jstate)
    assert sorted(got) == sorted(want)
    for key in want:
        # Parameters, statistics and u are O(1) and held absolutely.
        # Adam's moments scale with the gradients (nu reaches hundreds
        # here), so they are held relative to the tensor's largest entry.
        scale = (max(1.0, float(np.abs(want[key]).max()))
                 if "_opt/" in key else 1.0)
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=atol * scale, err_msg=key)


def assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        # f32 on both sides; XLA-CPU and ATen sum convolutions and
        # reductions in different orders.
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-3, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_train_steps_match_jax(variant):
    jcfg, tcfg = configs(**VARIANTS[variant])
    jstate = perturbed_state(jcfg, seed=1)
    tstate = load_train_state(create_train_state(tcfg, device="cpu"),
                              flatten_state(jstate))
    assert_states_close(tstate, jstate, atol=0)
    jstep = j_make_train_step(jcfg)
    tstep = make_train_step(tcfg)
    rng = jax.random.key(3)
    expected = {"g_loss", "g_disc_loss", "g_reco_loss", "g_sharp_loss",
                "d_loss", "d_gradient_pen", "g_gradient_param",
                "d_gradient_param", "d_real", "d_fake", "g_acd", "g_lsd",
                "g_extreme_rmse", "g_ws_weighted_rmse", "g_ws_rmse",
                "g_spatial_ks"}
    for step, atol in ((0, 1e-4), (1, 5e-4)):
        low_res, high_res = batch(seed=10 + step)
        draws = jax_draws(jcfg, rng, step, low_res, high_res)
        jstate, want = jstep(jstate, low_res, high_res, rng)
        tstate, got = tstep(tstate, low_res, high_res, draws=draws)
        assert set(got) == expected
        assert_metrics_close(got, want)
        assert tstate.step == int(jstate.step) == step + 1
        assert_states_close(tstate, jstate, atol=atol)


def test_eval_step_matches_jax():
    jcfg, tcfg = configs()
    jstate = perturbed_state(jcfg, seed=2)
    tstate = load_train_state(create_train_state(tcfg, device="cpu"),
                              flatten_state(jstate))
    low_res, high_res = batch(seed=20)
    rng = jax.random.key(5)
    noise = jax.random.normal(
        rng, low_res.shape[:4] + (MODEL["noise_channels"],))
    want = j_make_eval_step(jcfg)(jstate, low_res, high_res, rng)
    got = make_eval_step(tcfg)(tstate, low_res, high_res,
                               noise=torch.from_numpy(np.asarray(noise)))
    assert_metrics_close(got, want)
    assert_states_close(tstate, jstate, atol=0)   # eval moves no state


# ---- optimizers ------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_optimizer_steps_match_optax(name):
    import optax

    from windtpu.train import optim as joptim

    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4), dtype=np.float32),
          "b": rng.standard_normal(5, dtype=np.float32)}
    # Gradients around eps = 0.1 in size, where eps inside or outside the
    # root, or a missing bias correction, would show.
    grads = [{k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = joptim.discriminator_optimizer(JTrainConfig(optimizer=name))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = tx.init(jp)
    params = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
              for k, v in p0.items()]
    cfg = TrainConfig(optimizer=name)
    topt = (Adam(params, cfg.d_learning_rate, cfg.adam_b1, cfg.adam_b2,
                 cfg.adam_eps) if name == "adam"
            else RMSprop(params, cfg.rmsprop_learning_rate))
    for g in grads:
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jopt, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step([torch.from_numpy(g[k]) for k, _ in params])
        for k, p in params:
            # The whole update is lr-sized (4e-4, 5e-5): hold it to 1e-3
            # of that.
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=4e-7, err_msg=k)
    moved = max(float(np.abs(p.detach().numpy() - p0[k]).max())
                for k, p in params)
    assert moved > 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_count_adam_equals_the_float_count_formula(dtype):
    """Adam takes its bias corrections from its count on the parameters'
    device; over 50 steps the parameters are bitwise those of the same
    update with the corrections as host floats of an int count."""
    gen = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(3, 4, generator=gen, dtype=dtype),
          "b": torch.randn(5, generator=gen, dtype=dtype)}
    cfg = TrainConfig()
    lr, b1, b2, eps = (cfg.d_learning_rate, cfg.adam_b1, cfg.adam_b2,
                       cfg.adam_eps)
    params = [(k, torch.nn.Parameter(v.clone())) for k, v in p0.items()]
    opt = Adam(params, lr, b1, b2, eps)
    want = {k: v.clone() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    for count in range(1, 51):
        grads = {k: 0.1 * torch.randn(v.shape, generator=gen, dtype=dtype)
                 for k, v in p0.items()}
        opt.step([grads[k] for k, _ in params])
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        for k, g in grads.items():
            mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            want[k].sub_(lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
        for k, p in params:
            assert torch.equal(p.detach(), want[k]), (count, k)
    assert opt.count == 50 and float(opt.count_t) == 50.0


def test_optimizer_count_is_an_int_beside_its_tensor():
    """``count`` is an int to checkpoints and the loop, read from the one
    device tensor: setting it, or loading a state, fills the tensor, and
    a step, or an increment on the device as a replayed graph makes,
    moves it.  RMSprop keeps no count."""
    named = [("w", torch.nn.Parameter(torch.ones(2, 3)))]
    opt = Adam(named, 1e-3, 0.5, 0.9, 0.1)
    for _ in range(3):
        opt.step([torch.full((2, 3), 0.5)])
    saved = opt.state_dict()
    assert isinstance(saved["count"], int) and saved["count"] == 3
    assert float(opt.count_t) == 3.0
    other = Adam([("w", torch.nn.Parameter(torch.zeros(2, 3)))], 1e-3, 0.5,
                 0.9, 0.1)
    other.load_state_dict(saved)
    assert other.count == 3 and float(other.count_t) == 3.0
    assert torch.equal(other.state["mu"][0], opt.state["mu"][0])
    opt.count = np.int32(7)
    assert type(opt.count) is int and float(opt.count_t) == 7.0
    opt.count += 6
    assert opt.count == 13 and float(opt.count_t) == 13.0
    opt.step([torch.full((2, 3), 0.5)])
    assert opt.count == 14 and float(opt.count_t) == 14.0
    opt.count_t.add_(3)
    assert type(opt.count) is int and opt.count == 17
    assert opt.state_dict()["count"] == 17
    assert opt.tensors()[-1] is opt.count_t
    rms = RMSprop(named, 5e-5)
    rms.step([torch.full((2, 3), 0.5)])
    assert rms.count == 0 and "count" not in rms.state_dict()
    assert [id(t) for t in rms.tensors()] == [id(t) for t in rms.state["nu"]]


def test_cpu_train_step_captures_no_graph():
    """Off the card the critic updates run op by op: no capture, no
    replay, no graph kept on the state."""
    _, tcfg = configs()
    state = create_train_state(tcfg, device="cpu")
    captures, replays = critic_graph.captures, critic_graph.replays
    step = make_train_step(tcfg)
    for seed in (1, 2):
        step(state, *batch(seed), torch.Generator().manual_seed(seed))
    assert (critic_graph.captures, critic_graph.replays) == (captures,
                                                             replays)
    assert state.critic_graph is None
    assert state.d_opt.count == 2 * tcfg.train.n_critic


def test_graph_key_follows_the_state_tensors_and_the_batch():
    """A graph of the critic updates is keyed on the batch's shapes, the
    step's settings and the addresses of the state's tensors: an in-place
    load keeps the key, a new state, a replaced tensor, another shape or
    another setting changes it."""
    _, tcfg = configs()
    state = create_train_state(tcfg, device="cpu")
    low, high = (torch.from_numpy(a) for a in batch(seed=1))
    critic = draw_step_noise(tcfg, low.shape, high.shape[-1],
                             torch.Generator().manual_seed(0), "cpu").critic
    settings = (2, 100.0, 0.1, False, False, False, True)

    def key(state=state, low=low, high=high, settings=settings):
        return critic_graph_key(state, settings,
                                _critic_inputs(low, high, critic))

    first = key()
    assert key() == first
    for net in (state.generator, state.discriminator):
        net.load_state_dict({k: v.clone() for k, v in
                             net.state_dict().items()})
    state.d_opt.load_state_dict(state.d_opt.state_dict())
    state.d_opt.count = 5
    assert key() == first
    assert key(low=low[:1], high=high[:1]) != first
    assert key(settings=settings[:-1] + (False,)) != first
    assert key(state=create_train_state(tcfg, device="cpu")) != first
    p = state.discriminator.score_dense.dense.kernel
    p.data = p.data.clone()
    assert key() != first


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "slot"])
def test_load_train_state_rejects_mismatch(fault):
    jcfg, tcfg = configs()
    flat = flatten_state(j_create_train_state(jcfg))
    if fault == "missing":
        del flat["d_params/hr_ln/ln/scale"]
    elif fault == "extra":
        flat["d_batch_stats/hr_ln/mean"] = np.zeros(4, np.float32)
    elif fault == "shape":
        flat["g_opt/mu/mid/bias"] = np.zeros(3, np.float32)
    else:
        del flat["d_opt/nu/score_dense/dense/kernel"]
    with pytest.raises(ValueError):
        load_train_state(create_train_state(tcfg, device="cpu"), flat)


# (remat, remat_gp): the cases of tests/test_train.py's
# test_remat_modes_are_semantics_preserving.
REMAT = [(False, True), (True, True), ("save_scans", True), ("d_only", True),
         ("d_only", False)]


@pytest.mark.parametrize("remat,remat_gp", REMAT)
def test_remat_modes_match_jax(remat, remat_gp):
    """One step with each rematerialisation mode against the JAX step with
    the same mode, from the same state, batch and draws.  Remat changes
    the gradients' computation, not the metric recompute that follows the
    updates, so that is left out, and one critic update takes every
    wrapped call: both cut JAX's compile time."""
    jcfg, tcfg = configs(remat=remat, remat_gp=remat_gp, n_critic=1,
                         compute_metrics=False)
    jstate = perturbed_state(jcfg, seed=4)
    tstate = load_train_state(create_train_state(tcfg, device="cpu"),
                              flatten_state(jstate))
    low_res, high_res = batch(seed=25)
    rng = jax.random.key(6)
    draws = jax_draws(jcfg, rng, 0, low_res, high_res)
    jstate, want = j_make_train_step(jcfg)(jstate, low_res, high_res, rng)
    tstate, got = make_train_step(tcfg)(tstate, low_res, high_res,
                                        draws=draws)
    assert_metrics_close(got, want)
    assert_states_close(tstate, jstate, atol=1e-4)


def _step_recorded(tcfg, draws, low_res, high_res):
    """One port step from a seeded state: the state written in the forwards
    (spectral vectors, running statistics), every gradient handed to the
    optimizers, and how often chosen layers were called."""
    state = create_train_state(tcfg, seed=7, device="cpu")
    grads = []
    for opt in (state.g_opt, state.d_opt):
        def step(g, _step=opt.step):
            grads.append([x.clone() for x in g])
            _step(g)
        opt.step = step
    calls = {}
    layers = {"generator": state.generator.mid,
              "generator's ConvLSTM": state.generator.convlstm,
              "critic": state.discriminator.hr_conv}
    for name, layer in layers.items():
        calls[name] = 0
        layer.register_forward_hook(
            lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
    state, _ = make_train_step(tcfg)(state, low_res, high_res, draws=draws)
    written = {k: v for k, v in export_train_state(state).items()
               if k.split("/")[0] in ("g_batch_stats", "g_spectral",
                                      "d_spectral")}
    return written, grads, calls


@pytest.mark.parametrize("remat,remat_gp", REMAT)
def test_remat_updates_state_once(remat, remat_gp):
    """A remat step recomputes the wrapped forwards, and yet writes each
    spectral vector and running statistic once and differentiates the
    forward as it first ran: state and gradients equal a remat=False
    step's.  Under "save_scans" the generator's ConvLSTM (the kernel on a
    card) is not run again."""
    _, plain = configs()
    _, tcfg = configs(remat=remat, remat_gp=remat_gp)
    low_res, high_res = batch(seed=26)
    draws = draw_step_noise(tcfg, low_res.shape, 2,
                            torch.Generator().manual_seed(8), "cpu")
    want_state, want_grads, want_calls = _step_recorded(plain, draws,
                                                        low_res, high_res)
    got_state, got_grads, got_calls = _step_recorded(tcfg, draws, low_res,
                                                     high_res)
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    assert len(got_grads) == len(want_grads) == TRAIN["n_critic"] + 1
    for got, want in zip(got_grads, want_grads):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)
    recomputed = {"generator": remat in (True, "save_scans"),
                  "generator's ConvLSTM": remat is True,
                  "critic": remat is not False}
    for name, again in recomputed.items():
        if again:
            assert got_calls[name] > want_calls[name], name
        else:
            assert got_calls[name] == want_calls[name], name


def test_unknown_remat_mode_raises():
    _, tcfg = configs(remat="everything")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(tcfg)


def test_draws_have_the_batch_shapes_and_follow_the_generator():
    _, tcfg = configs()
    shape = (3, 2, 8, 12, 3)
    a = draw_step_noise(tcfg, shape, 2, torch.Generator().manual_seed(4),
                        "cpu")
    b = draw_step_noise(tcfg, shape, 2, torch.Generator().manual_seed(4),
                        "cpu")
    assert len(a.critic) == tcfg.train.n_critic
    for da, db in zip(a.critic, b.critic):
        assert da.noise.shape == (3, 2, 8, 12, 2)
        assert da.eps.shape == (3, 1, 1, 1, 1)
        assert float(da.eps.min()) >= 0 and float(da.eps.max()) < 1
        assert da.inst_real.shape == da.inst_fake.shape == (3, 2, 8, 12, 2)
        assert not torch.equal(da.inst_real, da.inst_fake)
        assert torch.equal(da.noise, db.noise)
    assert a.gen_noise.shape == a.eval_noise.shape == (3, 2, 8, 12, 2)
    assert torch.equal(a.eval_noise, b.eval_noise)
    no_metrics = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, compute_metrics=False))
    assert draw_step_noise(no_metrics, shape, 2, torch.Generator(),
                           "cpu").eval_noise is None


# ---- checkpoints, the loop, the holder -------------------------------------

def _batches(n, seed=30):
    return [batch(seed + i) for i in range(n)]


def _states_equal(a, b):
    fa, fb = export_train_state(a), export_train_state(b)
    assert sorted(fa) == sorted(fb)
    return all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_checkpoint_round_trip_and_latest(tmp_path):
    _, tcfg = configs()
    state = create_train_state(tcfg, device="cpu")
    step = make_train_step(tcfg)
    rng = torch.Generator().manual_seed(0)
    state, _ = step(state, *batch(40), rng)
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    path = ckpt.save_checkpoint(tmp_path, state)
    assert path.endswith("step_00000001.pt")
    assert ckpt.save_checkpoint(tmp_path, state) == path   # same step
    state, _ = step(state, *batch(41), rng)
    later = ckpt.save_checkpoint(tmp_path, state)
    # Partial and foreign names sort after the finished checkpoints and
    # must not be taken for one.
    for name in ("step_00000002.pt.tmp-123", "step_00000003.pt.part",
                 "step_x.pt", "step_00000009"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint(tmp_path) == later
    fresh = create_train_state(tcfg, seed=5, device="cpu")
    assert not _states_equal(fresh, state)
    ckpt.restore_checkpoint(later, fresh)
    assert fresh.step == 2 and _states_equal(fresh, state)
    # The restored state goes on exactly as the original does.
    draws = draw_step_noise(tcfg, (2, 2, 24, 24, 3), 2,
                            torch.Generator().manual_seed(1), "cpu")
    _, m1 = step(state, *batch(42), draws=draws)
    _, m2 = step(fresh, *batch(42), draws=draws)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)
    assert _states_equal(fresh, state)


def test_loop_trains_logs_saves_and_resumes(tmp_path, capsys):
    _, tcfg = configs(compute_spatial_ks=False)
    tcfg = dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "ck"))
    seen = []
    state, history = loop.train(
        tcfg, _batches(3), 3, log_every=2, checkpoint_every=2,
        log_fn=lambda s, m: seen.append(s), device="cpu")
    assert state.step == 3
    assert [s for s, _ in history] == seen == [1, 2]
    assert history[0][1]["steps_per_sec"] == 1.0
    assert all(np.isfinite(v) for _, m in history for v in m.values())
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["metrics.jsonl", "step_00000002.pt", "step_00000003.pt"]
    assert len((tmp_path / "ck" / "metrics.jsonl").read_text()
               .splitlines()) == 2
    # A second call resumes from step 3 and runs two more.
    resumed, _ = loop.train(tcfg, _batches(2, seed=50), 2, device="cpu")
    assert resumed.step == 5
    assert "resumed from" in capsys.readouterr().out
    assert (tmp_path / "ck" / "step_00000005.pt").exists()


def test_steps_per_call_runs_every_step_and_reports_the_last(tmp_path):
    _, tcfg = configs(steps_per_call=2, compute_spatial_ks=False,
                      compute_metrics=False)
    _, one = configs(compute_spatial_ks=False, compute_metrics=False)
    s2, h2 = loop.train(tcfg, _batches(3), 3, log_every=1,
                        log_fn=lambda s, m: None, device="cpu")
    s1, h1 = loop.train(one, _batches(3), 3, log_every=1,
                        log_fn=lambda s, m: None, device="cpu")
    assert s2.step == s1.step == 3
    assert [s for s, _ in h2] == [2, 3] and [s for s, _ in h1] == [1, 2, 3]
    # Same seed, same batches, same draws in the same order.
    assert _states_equal(s1, s2)
    for key in ("g_loss", "d_loss"):
        assert h2[0][1][key] == h1[1][1][key]


def test_holder_trains_and_exports_a_generator_the_jax_package_loads(
        tmp_path):
    jcfg, tcfg = configs()
    net = WindDownscalingGAN(tcfg, device="cpu")
    before = export_train_state(net.state)
    rng = torch.Generator().manual_seed(2)
    for i in range(2):
        metrics = net.train_step(*batch(60 + i), rng)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 0.0 <= float(metrics["g_spatial_ks"]) <= 1.0
    after = export_train_state(net.state)
    for prefix in ("g_params/", "d_params/", "g_batch_stats/", "g_spectral/",
                   "d_spectral/"):
        assert any(not np.array_equal(before[k], after[k])
                   for k in before if k.startswith(prefix)), prefix
    low_res, high_res = batch(70)
    test = net.test_step(low_res, high_res, rng)
    assert set(test) == {"loss", "d_real", "d_fake", "g_acd", "g_lsd",
                         "g_extreme_rmse", "g_ws_weighted_rmse", "g_ws_rmse"}
    assert net.discriminate(low_res, high_res).shape == (2, 1)

    # Directory round trip through the holder.
    path = net.save_weights(tmp_path / "ck")
    other = WindDownscalingGAN(tcfg, device="cpu", seed=9)
    other.load_weights(tmp_path / "ck")
    assert _states_equal(other.state, net.state)
    other.load_weights(path)
    with pytest.raises(FileNotFoundError):
        other.load_weights(tmp_path)

    # The trained generator, exported flat, loads into the JAX package and
    # gives the same forward.
    npz = ckpt.save_generator_npz(tmp_path / "gen.npz", net.generator)
    template = j_create_train_state(jcfg).g_variables()
    jvars = jckpt.load_generator_npz(npz, jax.device_get(template))
    noise = np.random.default_rng(3).standard_normal(
        low_res.shape[:4] + (2,), dtype=np.float32)
    want = np.asarray(JGenerator(jcfg.model).apply(
        jvars, low_res, noise, train=False))
    with torch.no_grad():
        got = net.generator(torch.from_numpy(low_res),
                            torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # And back into the port.
    other.load_weights(npz)
    with torch.no_grad():
        again = other.generator(torch.from_numpy(low_res),
                                torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(again, got)


def test_training_entry_points_default_to_the_card(monkeypatch):
    _, tcfg = configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(tcfg, [], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindDownscalingGAN(tcfg)


def test_loop_profile_dir_gets_a_trace(tmp_path):
    _, tcfg = configs(compute_spatial_ks=False, compute_metrics=False,
                      n_critic=1)
    loop.train(tcfg, _batches(4), 4, log_fn=lambda s, m: None,
               profile_dir=str(tmp_path / "prof"), device="cpu")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
