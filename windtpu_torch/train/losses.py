"""WGAN-GP losses and the perceptual reconstruction loss (counterpart of
``windtpu/train/losses.py``)."""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.distributed as dist

from windtpu_torch.core.mesh import psum


def discriminator_loss(real_score: torch.Tensor,
                       fake_score: torch.Tensor) -> torch.Tensor:
    """Wasserstein critic loss: -(E[real] - E[fake])."""
    return -(torch.mean(real_score) - torch.mean(fake_score))


def generator_adversarial_loss(fake_score: torch.Tensor) -> torch.Tensor:
    """-E[D(G(z))]."""
    return -torch.mean(fake_score)


def gradient_penalty_from_grads(grads_image: torch.Tensor,
                                gamma: float = 100.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gamma * E[(||dD/dx||_{(1,2,3)} - 1)^2].

    The norm reduces over axes (1, 2, 3) = (T, H, W) of the 5-D image and
    leaves a per-(sample, channel) norm: it never folds the channel axis
    into the norm, unlike canonical WGAN-GP.  Returns (penalty,
    mean_grad_norm); the latter is the ``d_gradient_pen`` diagnostic."""
    norms = torch.sqrt(torch.sum(grads_image**2, dim=(1, 2, 3)))
    penalty = gamma * torch.mean((norms - 1.0) ** 2)
    return penalty, torch.mean(norms)


def gradient_penalty(critic_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, gamma: float = 100.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GP: interpolate, differentiate the critic for its input.  The
    penalty stays differentiable for the critic's parameters.

    ``critic_fn`` maps a high-res image batch to per-sample scores;
    ``eps`` has shape (B, 1, 1, 1, 1), uniform in [0, 1)."""
    mixed = (eps * real + (1.0 - eps) * fake).detach().requires_grad_()
    grads, = torch.autograd.grad(critic_fn(mixed).sum(), mixed,
                                 create_graph=True)
    return gradient_penalty_from_grads(grads, gamma)


def highpass_energy_ratio_loss(fake: torch.Tensor, truth: torch.Tensor,
                               sigma: float = 7.0, eps: float = 1e-6,
                               rel_floor: float = 0.05,
                               group=None) -> torch.Tensor:
    """Per-sample, per-channel squared log-ratio of high-pass energy, fake
    against truth:

        E_{b,c}[ ( log hp(fake_bc) - log hp(truth_bc) )^2 ]

    where hp(x) is the mean squared residual of a Gaussian blur at
    ``sigma``, computed with an FFT transfer function over (H, W) in f32.
    Both energies get an additive floor of ``rel_floor * mean(hp_truth)``
    over the batch, which bounds the term of a channel with almost no
    fine-scale energy and keeps its gradient usable.  With ``group`` (a
    process group over which a global batch is split in equal shards) that
    mean is the global batch's."""
    def hp_energy(x):
        x = x.float()
        h, w = x.shape[2], x.shape[3]
        ky = torch.fft.fftfreq(h, device=x.device)[:, None]
        kx = torch.fft.rfftfreq(w, device=x.device)[None, :]
        g = torch.exp(-2.0 * (math.pi * sigma) ** 2 * (ky ** 2 + kx ** 2))
        spec = torch.fft.rfft2(x, dim=(2, 3))
        blurred = torch.fft.irfft2(spec * g[None, None, :, :, None],
                                   s=(h, w), dim=(2, 3))
        return torch.mean((x - blurred) ** 2, dim=(1, 2, 3))   # (B, C)

    hp_f = hp_energy(fake)
    hp_t = hp_energy(truth)
    mean_t = torch.mean(hp_t)
    if group is not None:
        mean_t = psum(mean_t, group) / dist.get_world_size(group)
    floor = rel_floor * mean_t
    log_ratio = (torch.log(hp_f + floor + eps)
                 - torch.log(hp_t + floor + eps))
    return torch.mean(log_ratio ** 2)


class reconstruction_loss:
    """Perceptual feature-space loss:
    ``coefficient * E[ ||enc(low_res_uv) - enc(high_res)||_2 ]``, the norm
    over the feature axis, the mean over (B, T)."""

    def __init__(self, feature_extractor: Callable[[torch.Tensor],
                                                   torch.Tensor],
                 coefficient: float = 1.0):
        self.feature_extractor = feature_extractor
        self.coefficient = coefficient

    def __call__(self, low_res_uv: torch.Tensor,
                 high_res: torch.Tensor) -> torch.Tensor:
        delta = (self.feature_extractor(low_res_uv)
                 - self.feature_extractor(high_res))
        return self.coefficient * torch.mean(
            torch.sqrt(torch.sum(delta ** 2, dim=-1)))
