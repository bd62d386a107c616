"""Inference holder for the generator (counterpart of
``windtpu/network.py:WindDownscalingGAN`` without the training half: the
critic, optimizers and train/eval steps come with the training slice)."""

from __future__ import annotations

from typing import Optional

from windtpu_torch.core.config import GANConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.models.generator import init_generator
from windtpu_torch.weights import load_generator_npz


class WindDownscalingGAN:
    """``cfg``, the generator module on ``device``, and an optional texture
    gate calibration (``texture_gate``, a params dict or None)."""

    def __init__(self, cfg: GANConfig, device=None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = init_generator(
            cfg.model, cfg.seed if seed is None else seed, self.device)
        self.texture_gate = None

    def load_weights(self, filepath) -> "WindDownscalingGAN":
        """Load single-file generator weights (``.npz`` in the JAX
        package's ``save_generator_npz`` format)."""
        if not str(filepath).endswith(".npz"):
            raise ValueError(
                f"{filepath}: the port loads .npz generator weights only; "
                "Orbax checkpoint directories come with the training slice")
        load_generator_npz(filepath, self.generator)
        return self
