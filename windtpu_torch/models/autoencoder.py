"""Convolutional autoencoder whose encoder gives the perceptual features of
the reconstruction loss (counterpart of ``windtpu/models/autoencoder.py``).

The encoder is a pyramid of [SN conv 5x5 stride 3 with padding 1, channels
x2, LeakyReLU, LayerNorm] down to under 7 px, flattened per time step,
through a ``middle`` Dense only when the flat size is above twice the
latent size, then projected to ``latent_dimension``.  The decoder mirrors
it with bilinear upsampling and transpose convs.  Layer names are flax's
(``encoder/conv_96``, ``decoder/bn_0``, ...), so a flat flax variable dict
such as the bundled ``autoencoder-synth.npz`` loads with
:func:`windtpu_torch.weights.load_autoencoder_npz` and no renaming.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from windtpu_torch.metrics.metrics import opposite_cosine_similarity
from windtpu_torch.models import layers as L


def _encoder_sizes(size: int) -> Tuple[List[Tuple[int, int]], int]:
    """The pyramid's (input size, output size) per stage, and the last
    size."""
    sizes = []
    while size >= 7:
        out = (size + 2 - 5) // 3 + 1
        sizes.append((size, out))
        size = out
    return sizes, size


class Encoder(nn.Module):
    """(B, T, I, I, 2) -> (B, T, latent_dimension); ``train=True`` moves
    the spectral-norm ``u`` vectors."""

    def __init__(self, image_size: int = 96, latent_dimension: int = 96,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_size = image_size
        stages, final = _encoder_sizes(image_size)
        self.stages = [size for size, _ in stages]
        channels = 2
        for size in self.stages:
            self.add_module(f"conv_{size}", L.TimeConv(
                channels, 2 * channels, (5, 5), strides=(3, 3), padding=1,
                dtype=dtype))
            channels *= 2
            self.add_module(f"ln_{size}", L.KerasLayerNorm(channels,
                                                           dtype=dtype))
        flat = final * final * channels
        self.middle = None
        if flat > 2 * latent_dimension:
            mid = (flat + latent_dimension) // 2
            self.middle = L.TimeDense(flat, mid, dtype=dtype)
            flat = mid
        self.latent = L.TimeDense(flat, latent_dimension, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.shape[2] != self.image_size:
            raise ValueError(f"encoder built for {self.image_size} px, got "
                             f"{tuple(x.shape)}")
        for size in self.stages:
            x = getattr(self, f"conv_{size}")(x, update_sn_stats=train)
            x = getattr(self, f"ln_{size}")(x)
        x = x.reshape(x.shape[0], x.shape[1], -1)
        if self.middle is not None:
            x = self.middle(x)
        return self.latent(x)


class Decoder(nn.Module):
    """(B, T, latent_dimension) -> (B, T, I, I, 2); ``train=True``
    normalizes with the batch statistics and moves the running ones."""

    def __init__(self, image_size: int = 96, time_steps: int = 24,
                 latent_dimension: int = 96,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ld = latent_dimension
        self.dense1 = L.TimeDense(ld, ld * 6, dtype=dtype)
        self.dense2 = L.TimeDense(ld * 6, ld * 12, dtype=dtype)
        self.grid_channels = ld // 3
        size, channels, i = 6, ld // 3, 0
        while size < image_size // 2:
            new = channels // 2 if channels >= 4 else 2
            self.add_module(f"upconv_{i}", L.TimeConvTranspose(
                channels, new, (5, 5), strides=(1, 1), padding="SAME",
                use_spectral_norm=False, dtype=dtype))
            self.add_module(f"bn_{i}", L.TimeBatchNorm(new, dtype=dtype))
            size, channels, i = 2 * size, new, i + 1
        self.num_up = i
        new = channels // 2 if channels >= 4 else 2
        self.up_final = L.TimeConvTranspose(
            channels, new, (2, 2), strides=(2, 2), padding="VALID",
            use_spectral_norm=False, dtype=dtype)
        self.out = L.TimeConv(new, 2, (3, 3), padding="SAME",
                              use_spectral_norm=False, activation=None,
                              dtype=dtype)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.dense2(self.dense1(z))
        b, t = x.shape[:2]
        x = x.reshape(b, t, 6, 6, self.grid_channels)
        for i in range(self.num_up):
            x = L.bilinear_upsample_2x(x)
            x = getattr(self, f"upconv_{i}")(x)
            x = getattr(self, f"bn_{i}")(x, train)
        return self.out(self.up_final(x))


class AutoEncoder(nn.Module):
    def __init__(self, image_size: int = 96, time_steps: int = 24,
                 latent_dimension: int = 96,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = Encoder(image_size, latent_dimension, dtype)
        self.decoder = Decoder(image_size, time_steps, latent_dimension,
                               dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(self.encoder(x, train), train)

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.encoder(x, train)


def weighted_vector_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                         weights=(0.5, 0.5)) -> torch.Tensor:
    """0.5 * RMSE + 0.5 * opposite cosine similarity, per sample (B,)."""
    rmse = torch.sqrt(torch.sum(
        torch.mean((y_pred - y_true) ** 2, dim=(1, 2, 3)), dim=-1))
    ocs = opposite_cosine_similarity(y_true, y_pred)
    return rmse * weights[0] + ocs * weights[1]
