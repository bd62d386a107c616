"""Training state (counterpart of ``windtpu/train/state.py``): both
networks with their mutable statistics, both optimizers and the step
count.  The train step updates it in place."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from windtpu_torch.core.config import GANConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.models.discriminator import (
    Discriminator,
    init_discriminator,
)
from windtpu_torch.models.generator import Generator, init_generator
from windtpu_torch.train import optim


@dataclasses.dataclass
class GANTrainState:
    step: int
    generator: Generator
    g_opt: optim._Optimizer
    discriminator: Discriminator
    d_opt: optim._Optimizer

    @property
    def device(self) -> torch.device:
        return next(self.generator.parameters()).device


def create_train_state(cfg: GANConfig, seed: Optional[int] = None,
                       device=None,
                       generator: Optional[Generator] = None
                       ) -> GANTrainState:
    """Both networks from their seeded initialisers (the critic's seed is
    the generator's plus one) with fresh optimizers, on ``device`` (``None``
    means the card).  A ``generator`` that exists already is taken as it
    is, and the critic joins it on its device."""
    seed = cfg.seed if seed is None else seed
    if generator is None:
        device = resolve_device(device)
        generator = init_generator(cfg.model, seed, device)
    else:
        device = next(generator.parameters()).device
    discriminator = init_discriminator(cfg.model, seed + 1, device)
    return GANTrainState(
        step=0,
        generator=generator,
        g_opt=optim.generator_optimizer(generator, cfg.train),
        discriminator=discriminator,
        d_opt=optim.discriminator_optimizer(discriminator, cfg.train))
