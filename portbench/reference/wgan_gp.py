"""The WGAN-GP training step of the published model, written out in plain
PyTorch: ``n_critic`` critic updates (gradient penalty on
eps-interpolates with per-(sample, channel) norms over (T, H, W), instance
noise on both scored inputs, real and fake scored in one doubled batch),
one generator update, then the metric suite on the updated networks with
``train=False``.  Adam as optax computes it (bias-corrected moments, eps
after the root).

The state is a dict of tensors; :func:`step` returns a new one and the
step's metrics.  The random draws come in as an argument
(:func:`draws`), so the program's draws can be reproduced exactly from
the seed the program was given.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import networks as N
from portbench.reference.layers import Precision

EPSILON = 1e-7


def draws(n_critic: int, noise_channels: int, low_shape, out_channels: int,
          rng: torch.Generator, metrics: bool = True) -> Dict:
    """One step's random numbers in the order the published step draws
    them: per critic update noise, eps, instance noise real and fake; then
    the generator update's noise and the metric pass's noise."""
    b, t, h, w = low_shape[:4]

    def normal(c):
        return torch.randn((b, t, h, w, c), generator=rng, device=rng.device)

    critic = []
    for _ in range(n_critic):
        d = {"noise": normal(noise_channels)}
        d["eps"] = torch.rand((b, 1, 1, 1, 1), generator=rng,
                              device=rng.device)
        d["inst_real"] = normal(out_channels)
        d["inst_fake"] = normal(out_channels)
        critic.append(d)
    return {"critic": critic, "gen_noise": normal(noise_channels),
            "eval_noise": normal(noise_channels) if metrics else None}


def rows(d: Dict, start: int, size: int) -> Dict:
    """The draws of batch rows [start, start + size)."""
    def cut(x):
        return None if x is None else x[start:start + size]
    return {"critic": [{k: cut(v) for k, v in c.items()}
                       for c in d["critic"]],
            "gen_noise": cut(d["gen_noise"]),
            "eval_noise": cut(d["eval_noise"])}


# -- metric suite -------------------------------------------------------------

def _zero_nans(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _cos(a, b):
    a = a * torch.rsqrt(torch.clamp((a * a).sum(-1, keepdim=True), min=1e-12))
    b = b * torch.rsqrt(torch.clamp((b * b).sum(-1, keepdim=True), min=1e-12))
    return (a * b).sum(-1)


def generator_metrics(real, fake) -> Dict[str, torch.Tensor]:
    u, v, uh, vh = real[..., 0], real[..., 1], fake[..., 0], fake[..., 1]
    est = torch.sqrt(uh ** 2 + vh ** 2)
    rea = torch.sqrt(u ** 2 + v ** 2)
    beta = (4.0 + rea) / (4.0 + est)
    tau = torch.where(est >= rea, 0.425, 1.0 - 0.425)
    wsw = _zero_nans(tau * ((uh - beta * u) ** 2 + (vh - beta * v) ** 2))
    sq = real ** 2
    denom = sq.sum()
    weights = torch.where(denom == 0, torch.zeros_like(sq), sq / denom)
    ext = _zero_nans(weights * (real - fake) ** 2)
    pr = torch.abs(torch.fft.rfft2(real, dim=(2, 3))) ** 2 + EPSILON
    pf = torch.abs(torch.fft.rfft2(fake, dim=(2, 3))) ** 2 + EPSILON
    ratio = torch.where(pf == 0, torch.zeros_like(pr), pr / pf)
    log10 = torch.where(ratio > 0, torch.log(ratio) / math.log(10.0),
                        torch.zeros_like(ratio))
    lsd = _zero_nans(torch.sqrt(torch.mean((10.0 * log10) ** 2,
                                           dim=(1, 2, 3, 4))))
    cos = _cos(real, fake)
    return {
        "g_acd": torch.mean(torch.arccos(torch.clamp(cos, -1.0, 1.0))
                            / math.pi),
        "g_lsd": torch.mean(lsd),
        "g_extreme_rmse": torch.mean(torch.sqrt(ext.sum(dim=(1, 2, 3, 4)))),
        "g_ws_weighted_rmse": torch.mean(torch.sqrt(wsw.mean(dim=(1, 2, 3)))),
        "g_ws_rmse": torch.mean(torch.sqrt(
            _zero_nans((rea - est) ** 2).mean(dim=(1, 2, 3)))),
    }


# -- the step -----------------------------------------------------------------

def _mean_sq(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.mean(g.float() ** 2) for g in grads]).mean()


def _adam(params, grads, mu, nu, count, lr, b1, b2, eps):
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    out_p, out_mu, out_nu = {}, {}, {}
    for k, g in zip(params, grads):
        m = b1 * mu[k] + (1.0 - b1) * g
        n = b2 * nu[k] + (1.0 - b2) * g * g
        out_p[k] = params[k] - lr * (m / c1) / (torch.sqrt(n / c2) + eps)
        out_mu[k], out_nu[k] = m, n
    return out_p, out_mu, out_nu


def new_state(g_params, g_buffers, d_params, d_buffers) -> Dict:
    zeros = lambda p: {k: torch.zeros_like(v) for k, v in p.items()}  # noqa
    return {"g": dict(g_params), "gs": dict(g_buffers), "d": dict(d_params),
            "ds": dict(d_buffers), "g_mu": zeros(g_params),
            "g_nu": zeros(g_params), "d_mu": zeros(d_params),
            "d_nu": zeros(d_params), "g_count": 0, "d_count": 0}


def step(state: Dict, low, high, dr: Dict, hp: Dict, prec: Precision):
    """One train step; ``hp`` holds n_critic, gp_weight, noise_std,
    g_lr, d_lr, b1, b2, eps.  Returns (new state, metrics)."""
    st = dict(state)
    std = hp["noise_std"]
    b = low.shape[0]
    g_names, d_names = list(st["g"]), list(st["d"])

    def adam(which, grads):
        count = st[f"{which}_count"] + 1
        lr = hp["g_lr"] if which == "g" else hp["d_lr"]
        st[which], st[f"{which}_mu"], st[f"{which}_nu"] = _adam(
            st[which], grads, st[f"{which}_mu"], st[f"{which}_nu"], count,
            lr, hp["b1"], hp["b2"], hp["eps"])
        st[f"{which}_count"] = count

    for it in range(hp["n_critic"]):
        d = dr["critic"][it]
        with torch.no_grad():
            fake, moved = N.generator(st["g"], st["gs"], low, std * d["noise"],
                                      prec, train=True)
            st["gs"] = {**st["gs"], **moved}
            mixed = d["eps"] * high + (1.0 - d["eps"]) * fake
        dp = {k: v.detach().requires_grad_() for k, v in st["d"].items()}
        mixed.requires_grad_()
        scores, moved = N.critic(dp, st["ds"], low, mixed, prec, train=True)
        st["ds"] = {**st["ds"], **moved}
        g_img, = torch.autograd.grad(scores.sum(), mixed, create_graph=True)
        norms = torch.sqrt(torch.sum(g_img ** 2, dim=(1, 2, 3)))
        penalty = hp["gp_weight"] * torch.mean((norms - 1.0) ** 2)
        gp_mean = torch.mean(norms)
        real_in = high + std * d["inst_real"]
        fake_in = fake + std * d["inst_fake"]
        both, moved = N.critic(dp, st["ds"], torch.cat([low, low]),
                               torch.cat([real_in, fake_in]), prec,
                               train=True)
        st["ds"] = {**st["ds"], **moved}
        loss = -(torch.mean(both[:b]) - torch.mean(both[b:])) + penalty
        grads = torch.autograd.grad(loss, [dp[k] for k in d_names],
                                    allow_unused=True)
        grads = [torch.zeros_like(dp[k]) if g is None else g.detach()
                 for k, g in zip(d_names, grads)]
        adam("d", grads)
        d_grad_diag = _mean_sq(grads)

    gp = {k: v.detach().requires_grad_() for k, v in st["g"].items()}
    fake, moved = N.generator(gp, st["gs"], low, std * dr["gen_noise"], prec,
                              train=True)
    st["gs"] = {**st["gs"], **moved}
    scores, moved = N.critic(st["d"], st["ds"], low, fake, prec, train=True)
    st["ds"] = {**st["ds"], **moved}
    g_loss = -torch.mean(scores)
    grads = torch.autograd.grad(g_loss, [gp[k] for k in g_names],
                                allow_unused=True)
    grads = [torch.zeros_like(gp[k]) if g is None else g.detach()
             for k, g in zip(g_names, grads)]
    adam("g", grads)
    metrics = {"g_loss": g_loss.detach(), "d_gradient_pen": gp_mean.detach(),
               "g_gradient_param": _mean_sq(grads),
               "d_gradient_param": d_grad_diag}
    with torch.no_grad():
        hr_score, _ = N.critic(st["d"], st["ds"], low, high, prec)
        fake_e, _ = N.generator(st["g"], st["gs"], low,
                                std * dr["eval_noise"], prec)
        fk_score, _ = N.critic(st["d"], st["ds"], low, fake_e, prec)
        metrics.update(d_loss=-(torch.mean(hr_score) - torch.mean(fk_score)),
                       d_real=torch.mean(hr_score),
                       d_fake=torch.mean(fk_score),
                       **generator_metrics(high, fake_e))
    st = {k: ({n: t.detach() for n, t in v.items()} if isinstance(v, dict)
              else v) for k, v in st.items()}
    return st, metrics
