"""Noise generators (counterpart of ``windtpu/data/noise.py``, after the
reference's data_generator.py:296-335), drawing from explicit
``torch.Generator``s.

Both expose two forms:

* ``sample(generator, ...)`` — draws from the caller's generator, on that
  generator's device;
* ``__call__(bs, ...)`` — convenience wrapper that holds its own CPU
  generator seeded from ``random_seed``, mirroring the reference call
  signature.

Shapes, standard deviations and the structured generator's broadcast
pattern are the JAX package's.  The values are not: torch's generators do
not reproduce JAX's threefry streams, so a seed gives other draws than the
same seed there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class FlexibleNoiseGenerator:
    """IID N(0, std) noise of shape (B, T, X, Y, C) — the generator used by
    the shipped model (reference data_generator.py:319-335, api.py:74-75)."""

    def __init__(self, noise_shape: Tuple[int, ...], std: float = 1.0,
                 random_seed: Optional[int] = None):
        self.noise_shape = tuple(noise_shape)
        self.std = float(std)
        self._generator = torch.Generator().manual_seed(
            random_seed if random_seed is not None else 0)

    def sample(self, generator: torch.Generator, bs: Optional[int] = None,
               channels: Optional[int] = None,
               std: Optional[float] = None) -> torch.Tensor:
        b, t, x, y, c = self.noise_shape
        b = bs if bs is not None else b
        c = channels if channels is not None else c
        s = std if std is not None else self.std
        return s * torch.randn((b, t, x, y, c), generator=generator,
                               device=generator.device)

    def __call__(self, bs=None, channels=None, std=None) -> torch.Tensor:
        return self.sample(self._generator, bs, channels, std)


class NoiseGenerator:
    """Structured 4-channel noise: time-only / lon-only / lat-only /
    lonlat-varying fields broadcast to (B, T, X, Y, 4)
    (reference data_generator.py:296-316)."""

    def __init__(self, noise_shape: Tuple[int, ...], std: float = 1.0,
                 random_seed: Optional[int] = None):
        self.noise_shape = tuple(noise_shape)
        self.std = float(std)
        self._generator = torch.Generator().manual_seed(
            random_seed if random_seed is not None else 0)

    def sample(self, generator: torch.Generator,
               bs: Optional[int] = None) -> torch.Tensor:
        b0, t, x, y = self.noise_shape[:4]
        b = bs if bs is not None else b0
        s = self.std

        def normal(shape):
            return s * torch.randn(shape, generator=generator,
                                   device=generator.device)

        time_noise = normal((b, t, 1, 1))
        lon_noise = normal((b, 1, x, 1))
        lat_noise = normal((b, 1, 1, y))
        lonlat_noise = normal((b, 1, x, y))
        full = (b, t, x, y)
        return torch.stack(
            [n.expand(full) for n in (time_noise, lon_noise, lat_noise,
                                      lonlat_noise)],
            dim=-1,
        )

    def __call__(self, bs=None) -> torch.Tensor:
        return self.sample(self._generator, bs)
