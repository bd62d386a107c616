"""Optimizers with the JAX package's (optax's) update rules and
Keras-parity hyperparameters: Adam(1e-4 generator / 4e-4 critic, betas
(0.5, 0.9), eps 0.1) and the RMSprop(5e-5) option.

They take the gradients as an argument (the train step differentiates with
``torch.autograd.grad`` for explicit inputs and never fills ``.grad``), and
their state is explicit: slot tensors keyed by parameter name, so it can be
carried across from, and compared with, an optax state.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from windtpu_torch.core.config import TrainConfig


class _Optimizer:
    slots: Tuple[str, ...] = ()
    has_count = False

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]]):
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.count = 0
        self.state: Dict[str, List[torch.Tensor]] = {
            slot: [torch.zeros_like(p) for p in self.params]
            for slot in self.slots}

    def state_dict(self) -> dict:
        out = {slot: dict(zip(self.names, tensors))
               for slot, tensors in self.state.items()}
        if self.has_count:
            out["count"] = self.count
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        want = set(self.slots) | ({"count"} if self.has_count else set())
        if set(state) != want:
            raise ValueError(f"optimizer state has {sorted(state)}; "
                             f"expected {sorted(want)}")
        for slot in self.slots:
            if set(state[slot]) != set(self.names):
                missing = sorted(set(self.names) - set(state[slot]))
                extra = sorted(set(state[slot]) - set(self.names))
                raise ValueError(f"optimizer slot {slot!r}: "
                                 f"missing={missing[:5]} extra={extra[:5]}")
            for name, dst in zip(self.names, self.state[slot]):
                src = state[slot][name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if src.shape != dst.shape:
                    raise ValueError(
                        f"optimizer slot {slot!r} of {name}: shape "
                        f"{tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(src)
        if self.has_count:
            self.count = int(state["count"])


class Adam(_Optimizer):
    """``optax.adam``: bias-corrected moments, eps added after the root."""

    slots = ("mu", "nu")
    has_count = True

    def __init__(self, named_params, lr: float, b1: float, b2: float,
                 eps: float):
        super().__init__(named_params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.state["mu"],
                                self.state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))


class RMSprop(_Optimizer):
    """``optax.rmsprop`` as the JAX package calls it: ``nu`` starts at 0,
    eps sits inside the root, no momentum: ``g * rsqrt(nu + eps)``."""

    slots = ("nu",)

    def __init__(self, named_params, lr: float, decay: float = 0.9,
                 eps: float = 1e-7):
        super().__init__(named_params)
        self.lr, self.decay, self.eps = lr, decay, eps

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g, nu in zip(self.params, grads, self.state["nu"]):
            nu.mul_(self.decay).addcmul_(g, g, value=1.0 - self.decay)
            p.sub_(self.lr * g * torch.rsqrt(nu + self.eps))


def _optimizer(module: nn.Module, cfg: TrainConfig, adam_lr: float):
    if cfg.optimizer == "rmsprop":
        return RMSprop(module.named_parameters(), cfg.rmsprop_learning_rate)
    return Adam(module.named_parameters(), adam_lr, cfg.adam_b1, cfg.adam_b2,
                cfg.adam_eps)


def generator_optimizer(module: nn.Module, cfg: TrainConfig = TrainConfig()):
    return _optimizer(module, cfg, cfg.g_learning_rate)


def discriminator_optimizer(module: nn.Module,
                            cfg: TrainConfig = TrainConfig()):
    return _optimizer(module, cfg, cfg.d_learning_rate)
