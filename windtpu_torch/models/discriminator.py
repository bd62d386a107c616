"""Wasserstein critic (counterpart of ``windtpu/models/discriminator.py``).

* branch A: high-res only  -> ConvLSTM(out_ch) -> SN conv 3x3 (F) -> LN
* branch B: concat(LR,HR)  -> ConvLSTM(F)      -> SN conv 3x3 (F) -> LN
* concat -> pyramid of [pad1 + SN conv 7x7 s3, channels x2, LN] while the
  spatial size >= 16, a second such pyramid while >= 4 (with a strided
  shortcut residual added when that pyramid ran at least
  ``discriminator_shortcut_min_iters`` times), a third pyramid of
  [SN conv 3x3 s2, channels x2, LN] while > 2, then Flatten -> Dense(1) per
  time step -> mean over time.

The pyramid depths depend only on the image size, so the module is built
for ``config.image_size``.  Submodule and variable names are the flax
module's (``hr_convlstm``, ``pyr1_conv_<size>``, ``shortcut/conv``, ...).

Both ConvLSTMs are built on :func:`windtpu_torch.models.layers.convlstm_scan`:
the critic sits inside the twice-differentiated gradient penalty, and its
narrow recurrences (F = 2 and 16) never reach the TPU kernel in the JAX
package either.
"""

from __future__ import annotations

import torch
from torch import nn

from windtpu_torch.core.config import ModelConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.models import layers as L
from windtpu_torch.models.generator import compute_dtype


def _pyramid_sizes(size: int):
    """Static per-stage spatial sizes (in, out) of the three conv pyramids
    and the final size.  Raises for image sizes whose pyramid collapses to
    zero pixels (e.g. 16, where stage 2 would need a 7x7 conv on a 4 px
    map)."""
    def _step(size, kernel, stride, pad):
        out = (size + 2 * pad - kernel) // stride + 1
        if out <= 0:
            raise ValueError(
                f"discriminator pyramid collapses at spatial size {size} "
                f"(conv {kernel}x{kernel}/s{stride} would output {out}px); "
                "choose an image size whose pyramid stays positive, e.g. "
                "24, 32, 48, 96")
        return out

    stage1 = []
    while size >= 16:
        out = _step(size, 7, 3, 1)
        stage1.append((size, out))
        size = out
    stage2 = []
    while size >= 4:
        out = _step(size, 7, 3, 1)
        stage2.append((size, out))
        size = out
    stage3 = []
    while size > 2:
        out = (size - 3) // 2 + 1
        stage3.append((size, out))
        size = out
    return stage1, stage2, stage3, size


class Discriminator(nn.Module):
    """``forward(low_res, high_res, train=False)`` with low_res
    (B, T, I, I, in_channels) and high_res (B, T, I, I, out_channels) ->
    float32 critic scores (B, 1).  ``train=True`` advances the
    spectral-norm ``u`` vectors."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = self.config = config
        f = cfg.discriminator_features
        dt = self.dtype = compute_dtype(cfg)
        c_hr, c_mix = cfg.out_channels, cfg.in_channels + cfg.out_channels
        if cfg.critic_fused_branches:
            self.hr_convlstm = L.ConvLSTMParams(c_hr, c_hr)
            self.mix_convlstm = L.ConvLSTMParams(c_mix, f)
        else:
            self.hr_convlstm = L.ConvLSTM(
                c_hr, c_hr, recurrence=L.convlstm_scan, dtype=dt)
            self.mix_convlstm = L.ConvLSTM(
                c_mix, f, recurrence=L.convlstm_scan, dtype=dt)
        self.hr_conv = L.TimeConv(c_hr, f, (3, 3), padding="SAME", dtype=dt)
        self.hr_ln = L.KerasLayerNorm(f, dtype=dt)
        self.mix_conv = L.TimeConv(f, f, (3, 3), padding="SAME", dtype=dt)
        self.mix_ln = L.KerasLayerNorm(f, dtype=dt)

        stage1, stage2, stage3, last = _pyramid_sizes(cfg.image_size)
        self.pyramid1, ch = self._pyramid("pyr1", stage1, 2 * f,
                                          (7, 7), (3, 3), 1)
        shortcut_in = ch
        shortcut_size = stage1[-1][1] if stage1 else cfg.image_size
        self.pyramid2, ch = self._pyramid("pyr2", stage2, ch,
                                          (7, 7), (3, 3), 1)
        self.has_shortcut = (
            len(stage2) >= cfg.discriminator_shortcut_min_iters)
        if self.has_shortcut:
            self.shortcut = L.ShortcutConv(
                shortcut_in, ch, in_size=shortcut_size,
                target_size=stage2[-1][1] if stage2 else shortcut_size,
                dtype=dt)
        self.pyramid3, ch = self._pyramid("pyr3", stage3, ch,
                                          (3, 3), (2, 2), "VALID")
        self.score_dense = L.TimeDense(last * last * ch, 1, dtype=dt)

    def _pyramid(self, prefix, stage, ch, kernel, strides, padding):
        """Register one [SN conv, channels x2, LN] stack under the flax
        names; returns its (conv, norm) attribute names and the channel
        count after it."""
        names = []
        for size, _out in stage:
            conv, norm = f"{prefix}_conv_{size}", f"{prefix}_ln_{size}"
            self.add_module(conv, L.TimeConv(
                ch, 2 * ch, kernel, strides=strides, padding=padding,
                dtype=self.dtype))
            self.add_module(norm, L.KerasLayerNorm(2 * ch, dtype=self.dtype))
            names.append((conv, norm))
            ch *= 2
        return names, ch

    def forward(self, low_res: torch.Tensor, high_res: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        cfg = self.config
        if low_res.shape[:-1] != high_res.shape[:-1]:
            raise ValueError(
                "low_res and high_res must share (B, T, H, W); upsample the "
                "low-res field first")
        if high_res.shape[2] != cfg.image_size \
                or high_res.shape[3] != cfg.image_size:
            raise ValueError(
                f"this critic was built for {cfg.image_size} px fields; got "
                f"{tuple(high_res.shape[2:4])}")
        low_res = low_res.to(self.dtype)
        high_res = high_res.to(self.dtype)
        mix_in = torch.cat([low_res, high_res], dim=-1)
        if cfg.critic_fused_branches:
            c_in = cfg.in_channels
            hr, mix = L.fused_dual_convlstm(
                mix_in, (c_in, c_in + cfg.out_channels),
                (0, c_in + cfg.out_channels), self.hr_convlstm.tensors(),
                self.mix_convlstm.tensors())
        else:
            hr = self.hr_convlstm(high_res)
            mix = self.mix_convlstm(mix_in)
        hr = self.hr_ln(self.hr_conv(hr, train))
        mix = self.mix_ln(self.mix_conv(mix, train))
        x = torch.cat([hr, mix], dim=-1)

        for conv, norm in self.pyramid1:
            x = getattr(self, norm)(getattr(self, conv)(x, train))
        shortcut = x
        for conv, norm in self.pyramid2:
            x = getattr(self, norm)(getattr(self, conv)(x, train))
        if self.has_shortcut:
            x = x + self.shortcut(shortcut, train)
        for conv, norm in self.pyramid3:
            x = getattr(self, norm)(getattr(self, conv)(x, train))

        b, t = x.shape[:2]
        x = self.score_dense(x.reshape(b, t, -1))   # (B, T, 1)
        return x.mean(dim=1).float()                # (B, 1)


def init_discriminator(config: ModelConfig, seed: int = 0,
                       device=None) -> Discriminator:
    """A critic with random weights drawn from ``seed``
    (:func:`windtpu_torch.models.layers.init_variables`), on ``device``
    (``None`` means the card; see ``core.device.resolve_device``)."""
    device = resolve_device(device)
    return L.init_variables(Discriminator(config), seed).to(device).eval()
