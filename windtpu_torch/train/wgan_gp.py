"""WGAN-GP optimization step (counterpart of ``windtpu/train/wgan_gp.py``).

One step is ``n_critic`` critic updates (gradient penalty on
eps-interpolates + instance-noised real/fake scoring), one generator update
and a metric recompute with ``train=False``, in the JAX step's order of
operations, because state moves on every training forward:

* the generator's BatchNorm running statistics and spectral-norm ``u``
  advance in each of the ``n_critic`` generator forwards and in the
  generator update;
* the critic's ``u`` advances in the gradient-penalty call, then in the
  scoring call (once with ``fused_scoring``, which scores real and fake in
  one doubled batch, twice without), then once more inside the generator
  loss;
* the GP norm reduces over axes (1, 2, 3) and leaves per-channel norms;
* instance noise (std = noise_std, out_channels wide) is added to BOTH
  critic inputs when scoring;
* ``detach_gp=True`` logs the penalty without training the critic on it.

The random draws are split from the arithmetic: :func:`draw_step_noise`
draws everything a step needs from a ``torch.Generator``, and the step
takes the draws, so a test can hand the same numbers to this step and to
the JAX one.  Gradients are taken with ``torch.autograd.grad`` for the
updated network's parameters only; ``.grad`` fields are never filled.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from windtpu_torch.core.config import GANConfig, TrainConfig
from windtpu_torch.metrics import metrics as M
from windtpu_torch.train.losses import (
    discriminator_loss,
    generator_adversarial_loss,
    gradient_penalty_from_grads,
    highpass_energy_ratio_loss,
)
from windtpu_torch.train.state import GANTrainState


@dataclasses.dataclass
class CriticDraws:
    noise: torch.Tensor    # (B, T, H, W, noise_channels), unit normal
    eps: torch.Tensor      # (B, 1, 1, 1, 1), uniform in [0, 1)
    inst_real: torch.Tensor   # (B, T, H, W, out_channels), unit normal
    inst_fake: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    """Every random number of one train step, before scaling by
    ``noise_std``."""
    critic: List[CriticDraws]
    gen_noise: torch.Tensor
    eval_noise: Optional[torch.Tensor]   # None without compute_metrics


def draw_step_noise(cfg: GANConfig, low_res_shape: Sequence[int],
                    out_channels: int, rng: torch.Generator,
                    device=None) -> StepDraws:
    """Draw one step's random numbers from ``rng`` (on its own device) and
    move them to ``device``.  Shapes come from the batch, not from
    ``ModelConfig``: the networks are fully convolutional."""
    b, t, h, w = low_res_shape[:4]
    noise_shape = (b, t, h, w, cfg.model.noise_channels)
    inst_shape = (b, t, h, w, out_channels)

    def normal(shape):
        return torch.randn(shape, generator=rng,
                           device=rng.device).to(device)

    critic = [CriticDraws(
        noise=normal(noise_shape),
        eps=torch.rand((b, 1, 1, 1, 1), generator=rng,
                       device=rng.device).to(device),
        inst_real=normal(inst_shape), inst_fake=normal(inst_shape))
        for _ in range(cfg.train.n_critic)]
    return StepDraws(
        critic=critic, gen_noise=normal(noise_shape),
        eval_noise=(normal(noise_shape) if cfg.train.compute_metrics
                    else None))


def check_ported(tcfg: TrainConfig) -> None:
    """Options of ``TrainConfig`` whose slice of the port is still to come
    raise here instead of being ignored (ROADMAP A)."""
    if tcfg.remat is not False or tcfg.remat_gp:
        raise NotImplementedError(
            "TrainConfig.remat / remat_gp: the rematerialization modes are "
            "not ported yet (ROADMAP A13)")
    if tcfg.reconstruction_coefficient > 0:
        raise NotImplementedError(
            "TrainConfig.reconstruction_coefficient > 0: the perceptual "
            "reconstruction loss comes with the autoencoder slice "
            "(ROADMAP A10)")


def _grads_or_zeros(loss: torch.Tensor,
                    params: List[nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params, with zeros where the loss does not reach a
    parameter (or is a constant)."""
    if not loss.requires_grad:
        return [torch.zeros_like(p) for p in params]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _tensor_mean_sq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over parameter tensors of mean(g^2): the gradient diagnostic."""
    return torch.stack([torch.mean(g.float() ** 2) for g in grads]).mean()


def _batch(state: GANTrainState, cfg: GANConfig, low_res,
           high_res) -> Tuple[torch.Tensor, torch.Tensor]:
    device = state.device
    low_res = torch.as_tensor(low_res, dtype=torch.float32, device=device)
    high_res = torch.as_tensor(high_res, dtype=torch.float32, device=device)
    if low_res.shape[-1] != cfg.model.in_channels:
        raise ValueError(
            f"batch has {low_res.shape[-1]} input channels but the "
            f"generator was built for ModelConfig.in_channels="
            f"{cfg.model.in_channels}; align DataConfig.input_variables "
            f"with ModelConfig")
    return low_res, high_res


def _generator_metrics(high_res: torch.Tensor,
                       fake: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "g_acd": torch.mean(M.angular_cosine_distance(high_res, fake)),
        "g_lsd": torch.mean(M.log_spectral_distance(high_res, fake)),
        "g_extreme_rmse": torch.mean(
            M.extreme_weighted_rmse(high_res, fake)),
        "g_ws_weighted_rmse": torch.mean(
            M.wind_speed_weighted_rmse(high_res, fake)),
        "g_ws_rmse": torch.mean(M.wind_speed_rmse(high_res, fake)),
    }


def make_train_step(cfg: GANConfig, detach_gp: Optional[bool] = None):
    """Build ``step(state, low_res, high_res, rng=None, *, draws=None) ->
    (state, metrics)``.  ``state`` is updated in place.  The step draws its
    random numbers from ``rng`` (a ``torch.Generator``) unless ``draws``
    (a :class:`StepDraws`) hands them in.  ``metrics`` maps the JAX
    package's metric names to 0-d tensors on the state's device."""
    tcfg = cfg.train
    check_ported(tcfg)
    detach = tcfg.detach_gp if detach_gp is None else detach_gp
    std = tcfg.noise_std

    def train_step(state: GANTrainState, low_res, high_res,
                   rng: Optional[torch.Generator] = None, *,
                   draws: Optional[StepDraws] = None):
        low_res, high_res = _batch(state, cfg, low_res, high_res)
        if draws is None:
            draws = draw_step_noise(cfg, low_res.shape, high_res.shape[-1],
                                    rng, state.device)
        gen, critic = state.generator, state.discriminator
        g_params, d_params = state.g_opt.params, state.d_opt.params
        b = low_res.shape[0]
        zero = torch.zeros((), device=state.device)
        gp_mean_norm = d_loss_val = d_grad_diag = zero

        # ---- critic updates --------------------------------------------
        for it in range(tcfg.n_critic):
            d = draws.critic[it]
            with torch.no_grad():
                fake = gen(low_res, std * d.noise, train=True)
                mixed = d.eps * high_res + (1.0 - d.eps) * fake
            mixed.requires_grad_()
            # Gradient penalty: the critic differentiated for its image
            # input, inside the loss that is differentiated for d_params.
            scores = critic(low_res, mixed, train=True)
            grads_img, = torch.autograd.grad(scores.sum(), mixed,
                                             create_graph=not detach)
            penalty, gp_mean_norm = gradient_penalty_from_grads(
                grads_img, tcfg.gp_weight)
            if detach:
                penalty = penalty.detach()
            real_in = high_res + std * d.inst_real
            fake_in = fake + std * d.inst_fake
            if tcfg.fused_scoring:
                # One critic call on the doubled batch: the critic has no
                # cross-sample op, so the scores are those of two calls.
                both = critic(torch.cat([low_res, low_res]),
                              torch.cat([real_in, fake_in]), train=True)
                rs, fs = both[:b], both[b:]
            else:
                rs = critic(low_res, real_in, train=True)
                fs = critic(low_res, fake_in, train=True)
            loss = discriminator_loss(rs, fs) + penalty
            d_grads = _grads_or_zeros(loss, d_params)
            state.d_opt.step(d_grads)
            d_loss_val = loss.detach()
            gp_mean_norm = gp_mean_norm.detach()
            d_grad_diag = _tensor_mean_sq(d_grads)

        # ---- generator update ------------------------------------------
        fake = gen(low_res, std * draws.gen_noise, train=True)
        g_adv = g_sharp = zero
        if tcfg.adversarial_coefficient > 0:   # 0 removes the critic call
            scores = critic(low_res, fake, train=True)
            g_adv = (tcfg.adversarial_coefficient
                     * generator_adversarial_loss(scores))
        if tcfg.sharpness_coefficient > 0:
            g_sharp = tcfg.sharpness_coefficient * highpass_energy_ratio_loss(
                fake, high_res, sigma=tcfg.sharpness_sigma)
        g_loss = g_adv + g_sharp
        g_grads = _grads_or_zeros(g_loss, g_params)
        state.g_opt.step(g_grads)

        metrics = {
            "g_loss": g_loss.detach(),
            "g_disc_loss": g_adv.detach(),
            "g_reco_loss": zero,
            "g_sharp_loss": g_sharp.detach(),
            "d_gradient_pen": gp_mean_norm,
            "g_gradient_param": _tensor_mean_sq(g_grads),
            "d_gradient_param": d_grad_diag,
        }
        del fake, g_loss, g_adv, g_sharp, g_grads

        # ---- metric recompute, train=False, on the updated parameters --
        if tcfg.compute_metrics:
            with torch.no_grad():
                hr_score = critic(low_res, high_res)
                fake_e = gen(low_res, std * draws.eval_noise)
                fk_score = critic(low_res, fake_e)
                metrics.update(
                    d_loss=discriminator_loss(hr_score, fk_score),
                    d_real=torch.mean(hr_score),
                    d_fake=torch.mean(fk_score),
                    **_generator_metrics(high_res, fake_e))
                if tcfg.compute_spatial_ks:
                    metrics["g_spatial_ks"] = M.spatial_ks_scalar(
                        high_res, fake_e)
        else:
            metrics["d_loss"] = d_loss_val
        state.step += 1
        return state, metrics

    return train_step


def make_multi_train_step(cfg: GANConfig, steps_per_call: int,
                          detach_gp: Optional[bool] = None):
    """``(state, low_res_k, high_res_k, rng) -> (state, metrics)`` where the
    batch arguments are length-K sequences; K steps run and the metrics are
    those of the LAST one."""
    inner = make_train_step(cfg, detach_gp=detach_gp)
    if steps_per_call <= 1:
        return inner

    def multi(state, low_res_k, high_res_k, rng):
        metrics = None
        for low_res, high_res in zip(low_res_k, high_res_k):
            state, metrics = inner(state, low_res, high_res, rng)
        return state, metrics

    return multi


def make_eval_step(cfg: GANConfig):
    """Build ``eval_step(state, low_res, high_res, rng=None, *, noise=None)
    -> metrics``: the critic loss on real against generated, and the
    generator metric suite, with ``train=False``.  ``noise`` (unit normal,
    (B, T, H, W, noise_channels)) replaces the draw from ``rng``."""
    mcfg, tcfg = cfg.model, cfg.train

    @torch.no_grad()
    def eval_step(state: GANTrainState, low_res, high_res,
                  rng: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None):
        low_res, high_res = _batch(state, cfg, low_res, high_res)
        if noise is None:
            noise = torch.randn(
                tuple(low_res.shape[:4]) + (mcfg.noise_channels,),
                generator=rng, device=rng.device).to(state.device)
        gen, critic = state.generator, state.discriminator
        true_scores = critic(low_res, high_res)
        generated = gen(low_res, tcfg.noise_std * noise)
        fake_scores = critic(low_res, generated)
        return {
            "loss": discriminator_loss(true_scores, fake_scores),
            "d_real": torch.mean(true_scores),
            "d_fake": torch.mean(fake_scores),
            **_generator_metrics(high_res, generated),
        }

    return eval_step
