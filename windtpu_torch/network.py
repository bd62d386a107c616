"""The GAN bundle: generator + critic + optimizers + config (counterpart
of ``windtpu/network.py:WindDownscalingGAN``).  It owns the train state
and exposes the train/eval entry points that delegate to
:mod:`windtpu_torch.train.wgan_gp`; ``save_weights``/``load_weights`` keep
the "one directory of checkpoints" contract with ``step_%08d.pt`` files.

The generator is built with the holder.  The training half (critic and
optimizers) is built when ``state`` is first read, so that a holder used
for inference alone carries no critic, and works at image sizes the
critic's pyramids do not take."""

from __future__ import annotations

import os
from typing import Optional

import torch

from windtpu_torch.core.config import GANConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.models.generator import init_generator
from windtpu_torch.train import checkpoint as ckpt
from windtpu_torch.train.state import GANTrainState, create_train_state
from windtpu_torch.train.wgan_gp import make_eval_step, make_train_step
from windtpu_torch.weights import load_generator_npz


class WindDownscalingGAN:
    """``cfg``, the generator and (on first use) the train state on
    ``device`` (``None`` means the card), and an optional texture gate
    calibration (``texture_gate``, a params dict or None)."""

    def __init__(self, cfg: GANConfig, device=None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = cfg.seed if seed is None else seed
        self.generator = init_generator(cfg.model, self.seed, self.device)
        self._state: Optional[GANTrainState] = None
        self._train_step = None
        self._eval_step = None
        self.texture_gate = None

    # -- forward -----------------------------------------------------------
    @property
    def state(self) -> GANTrainState:
        if self._state is None:
            self._state = create_train_state(self.cfg, self.seed,
                                             generator=self.generator)
        return self._state

    @property
    def discriminator(self):
        return self.state.discriminator

    @torch.no_grad()
    def discriminate(self, low_res, high_res) -> torch.Tensor:
        """Critic scores (B, 1) with ``train=False``."""
        low_res = torch.as_tensor(low_res, dtype=torch.float32,
                                  device=self.device)
        high_res = torch.as_tensor(high_res, dtype=torch.float32,
                                   device=self.device)
        return self.state.discriminator(low_res, high_res)

    # -- training ----------------------------------------------------------
    def train_step(self, low_res, high_res, rng: torch.Generator):
        """One WGAN-GP step on a (low_res, high_res) batch, with the
        step's random draws taken from ``rng``; returns the metrics."""
        if self._train_step is None:
            self._train_step = make_train_step(self.cfg)
        _, metrics = self._train_step(self.state, low_res, high_res, rng)
        return metrics

    def test_step(self, low_res, high_res, rng: torch.Generator):
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.cfg)
        return self._eval_step(self.state, low_res, high_res, rng)

    # -- checkpoint I/O ----------------------------------------------------
    def save_weights(self, filepath) -> str:
        """Write ``step_%08d.pt`` of the current state under the directory
        ``filepath``."""
        return ckpt.save_checkpoint(filepath, self.state)

    def load_weights(self, filepath) -> "WindDownscalingGAN":
        """Load single-file generator weights (``.npz`` in the JAX
        package's ``save_generator_npz`` format), one ``step_*.pt``
        checkpoint, or the latest checkpoint of a directory."""
        path = os.fspath(filepath)
        if path.endswith(".npz"):
            load_generator_npz(path, self.generator)
            return self
        if os.path.isdir(path):
            latest = ckpt.latest_checkpoint(path)
            if latest is None:
                raise FileNotFoundError(
                    f"no step_*.pt checkpoints under {path}")
            path = latest
        ckpt.restore_checkpoint(path, self.state)
        return self
