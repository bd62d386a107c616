"""Recurrent super-resolution generator (counterpart of
``windtpu/models/generator.py``).

Topology (image size I, feature width F, sequence length T):

    concat(img, noise)                                  (B,T,I,I,Cin+Cn)
    -> pad3 + SN conv 8x8 s2 + LReLU + BN   -> res_2    (B,T,I/2,I/2,min(8C,F))
    -> pad1 + SN conv 4x4 s2 + LReLU + BN   -> res_4    (B,T,I/4,I/4,F)
    -> ConvLSTM(F, 3x3)                                 (B,T,I/4,I/4,F)
    -> SN conv 3x3 + LReLU + BN                         (B,T,I/4,I/4,F/2)
    -> concat res_4 -> SN convT 2x2 s2 + LReLU + BN     (B,T,I/2,I/2,F/4)
    -> concat res_2 -> bilinear x2 + convT 5x5 + LReLU  (B,T,I,I,F/8)
       (or plain conv 3x3 when F/8 < out_channels)
    -> BN -> conv 3x3 linear                            (B,T,I,I,out)

Submodule and variable names are the flax module's, so a flax variable
path ``params/down1/kernel`` is the state-dict key ``down1.kernel``.
"""

from __future__ import annotations

import torch
from torch import nn

from windtpu_torch.core.config import ModelConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.models import layers as L
from windtpu_torch.ops.convlstm import convlstm_seq

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


class Generator(nn.Module):
    """``forward(image, noise, train=False)`` with image
    (B, T, I, I, in_channels) and noise (B, T, I, I, noise_channels) ->
    float32 (B, T, I, I, out_channels).  ``train=True`` normalizes with the
    batch statistics and advances the BatchNorm running statistics and the
    spectral-norm ``u`` vectors.  The ConvLSTM is built on the CUDA kernel
    (:func:`windtpu_torch.ops.convlstm.convlstm_seq`)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        f = cfg.generator_features
        dt = self.dtype = compute_dtype(cfg)
        total_in = cfg.in_channels + cfg.noise_channels
        inter = min(total_in * 8, f)
        self.down1 = L.TimeConv(
            total_in, inter, (8, 8), strides=(2, 2), padding=3, dtype=dt,
            split_input_at=cfg.in_channels if cfg.split_stem else 0)
        self.bn1 = L.TimeBatchNorm(inter, dtype=dt)
        self.down2 = L.TimeConv(inter, f, (4, 4), strides=(2, 2), padding=1,
                                dtype=dt)
        self.bn2 = L.TimeBatchNorm(f, dtype=dt)
        self.convlstm = L.ConvLSTM(f, f, recurrence=convlstm_seq, dtype=dt)
        self.mid = L.TimeConv(f, f // 2, (3, 3), padding="SAME", dtype=dt)
        self.bn3 = L.TimeBatchNorm(f // 2, dtype=dt)
        self.up1 = L.TimeConvTranspose(
            f // 2 + f, f // 4, (2, 2), strides=(2, 2), padding="VALID",
            use_spectral_norm=True, dtype=dt)
        self.bn4 = L.TimeBatchNorm(f // 4, dtype=dt)
        self.wide_head = f // 8 >= cfg.out_channels
        if self.wide_head:
            head = f // 8
            self.up2 = L.TimeConvTranspose(
                f // 4 + inter, head, (5, 5), strides=(1, 1), padding="SAME",
                use_spectral_norm=False, dtype=dt)
        else:
            head = cfg.out_channels
            self.up2_conv = L.TimeConv(
                f // 4 + inter, head, (3, 3), padding="SAME",
                use_spectral_norm=False, dtype=dt)
        self.bn5 = L.TimeBatchNorm(head, dtype=dt)
        self.out = L.TimeConv(head, cfg.out_channels, (3, 3), padding="SAME",
                              use_spectral_norm=False, activation=None,
                              dtype=dt)

    def forward(self, image: torch.Tensor, noise: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = torch.cat([image, noise], dim=-1).to(self.dtype)
        x = self.bn1(self.down1(x, train), train)
        res_2 = x
        x = self.bn2(self.down2(x, train), train)
        res_4 = x
        x = self.convlstm(x)
        x = self.bn3(self.mid(x, train), train)
        x = torch.cat([x, res_4], dim=-1)
        x = self.bn4(self.up1(x, train), train)
        x = torch.cat([x, res_2], dim=-1)
        x = L.bilinear_upsample_2x(x)
        x = self.up2(x) if self.wide_head else self.up2_conv(x)
        x = self.bn5(x, train)
        return self.out(x).float()


def init_generator(config: ModelConfig, seed: int = 0,
                   device=None) -> Generator:
    """A generator with random weights drawn from ``seed``
    (:func:`windtpu_torch.models.layers.init_variables`), on ``device``
    (``None`` means the card; see ``core.device.resolve_device``)."""
    device = resolve_device(device)
    return L.init_variables(Generator(config), seed).to(device).eval()
