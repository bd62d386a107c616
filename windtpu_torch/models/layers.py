"""Building blocks of the generator, in PyTorch.

Counterparts of ``windtpu/models/layers.py``.  The public layout is the JAX
package's: fields are ``(B, T, H, W, C)``, kernels are stored as HWIO
``(kh, kw, in, out)`` under the same names as the flax variables, so a flax
checkpoint loads by renaming alone (:mod:`windtpu_torch.weights`).  Inside,
time folds into the batch axis and each convolution runs on an NCHW view
of the NHWC data (a channels-last tensor, so no copy).

Semantics kept from the JAX layers:

* spectral normalization is one power step off the stored ``u`` with
  ``u`` left unchanged (inference), on the kernel matricized as
  ``reshape(-1, out)``; the transpose conv normalizes in TF layout
  ``(kh, kw, out, in)``, so its ``u`` lives in the in-channel space;
* the transpose conv has Keras semantics: ``F.conv_transpose2d`` with the
  HWIO kernel permuted to ``(in, out, kh, kw)`` and no flip;
* BatchNorm epsilon 1e-3 (Keras);
* the ConvLSTM hoists the input conv over all steps, folds the unit forget
  bias into it, and runs the recurrence in :mod:`windtpu_torch.ops.convlstm`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from windtpu_torch.ops.convlstm import convlstm_seq

Padding = Union[int, str]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + eps)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, kernel: torch.Tensor,
                strides: Tuple[int, int] = (1, 1),
                padding: Padding = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC/HWIO/NHWC dimension numbers.

    ``padding``: an int (symmetric), ``"SAME"`` or ``"VALID"``."""
    xn = x.permute(0, 3, 1, 2)
    w = kernel.permute(3, 2, 0, 1)
    if padding == "VALID":
        pad = (0, 0)
    elif padding == "SAME":
        kh, kw = kernel.shape[:2]
        ph = _same_pads(x.shape[1], kh, strides[0])
        pw = _same_pads(x.shape[2], kw, strides[1])
        if ph[0] != ph[1] or pw[0] != pw[1]:
            xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        else:
            pad = (ph[0], pw[0])
    elif isinstance(padding, int):
        pad = (padding, padding)
    else:
        raise ValueError(f"unsupported padding {padding!r}")
    y = F.conv2d(xn, w, stride=tuple(strides), padding=pad)
    return y.permute(0, 2, 3, 1)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _unfold(x: torch.Tensor, batch: int) -> torch.Tensor:
    return x.reshape((batch, -1) + tuple(x.shape[1:]))


class SpectralNorm(nn.Module):
    """``kernel / sigma`` with sigma from one power step off the stored
    ``u`` (shape ``(out,)``, the kernel's last axis).  ``u`` is a buffer and
    is never updated here."""

    def __init__(self, out_features: int):
        super().__init__()
        self.register_buffer("u", torch.empty(out_features))

    def forward(self, kernel: torch.Tensor) -> torch.Tensor:
        w = kernel.reshape(-1, kernel.shape[-1]).float()
        v = _l2_normalize(w @ self.u)
        u_new = _l2_normalize(v @ w)
        sigma = torch.einsum("i,io,o->", v, w.to(kernel.dtype),
                             u_new.to(kernel.dtype))
        return kernel / sigma


class _ConvParams(nn.Module):
    """A kernel/bias pair under flax ``nn.Conv``'s names."""

    def __init__(self, shape: Tuple[int, ...], features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(features))


class TimeConv(nn.Module):
    """Time-distributed Conv2D over (B, T, H, W, C) by time folding."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_spectral_norm: bool = True,
                 activation=leaky_relu, dtype: Optional[torch.dtype] = None,
                 split_input_at: int = 0):
        super().__init__()
        shape = tuple(kernel_size) + (in_features, features)
        self.strides = tuple(strides)
        self.padding = padding
        self.use_spectral_norm = use_spectral_norm
        self.activation = activation
        self.dtype = dtype
        self.split_input_at = split_input_at
        if use_spectral_norm:
            self.kernel = nn.Parameter(torch.empty(shape))
            self.bias = nn.Parameter(torch.empty(features))
            self.sn = SpectralNorm(features)
        else:
            self.conv = _ConvParams(shape, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded = _fold(x)
        if self.use_spectral_norm:
            kernel, bias = self.sn(self.kernel), self.bias
        else:
            kernel, bias = self.conv.kernel, self.conv.bias
        dt = self.dtype or folded.dtype
        folded, kernel = folded.to(dt), kernel.to(dt)
        s = self.split_input_at
        if 0 < s < folded.shape[-1]:
            y = (conv2d_nhwc(folded[..., :s], kernel[:, :, :s],
                             self.strides, self.padding)
                 + conv2d_nhwc(folded[..., s:], kernel[:, :, s:],
                               self.strides, self.padding))
        else:
            y = conv2d_nhwc(folded, kernel, self.strides, self.padding)
        y = y + bias.to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return _unfold(y, x.shape[0])


class TimeConvTranspose(nn.Module):
    """Time-distributed Keras Conv2DTranspose.

    Geometries: ``"VALID"`` at any stride, ``"SAME"`` at stride 1 with an
    odd kernel (the generator's ``up1`` and ``up2``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: str = "VALID",
                 use_spectral_norm: bool = False, activation=leaky_relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = kernel_size
        if padding == "VALID":
            self.pad = (0, 0)
        elif (padding == "SAME" and tuple(strides) == (1, 1)
              and kh % 2 and kw % 2):
            self.pad = (kh // 2, kw // 2)
        else:
            raise ValueError(
                f"unsupported transpose-conv geometry: kernel {kernel_size}, "
                f"strides {strides}, padding {padding!r}")
        shape = (kh, kw, in_features, features)
        self.strides = tuple(strides)
        self.use_spectral_norm = use_spectral_norm
        self.activation = activation
        self.dtype = dtype
        if use_spectral_norm:
            self.kernel = nn.Parameter(torch.empty(shape))
            self.bias = nn.Parameter(torch.empty(features))
            self.sn = SpectralNorm(in_features)
        else:
            self.conv = _ConvParams(shape, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded = _fold(x)
        if self.use_spectral_norm:
            kernel, bias = self.kernel, self.bias
        else:
            kernel, bias = self.conv.kernel, self.conv.bias
        # TF Conv2DTranspose layout (kh, kw, out, in): spectral norm is
        # taken in it so that u lives in the in-channel space.
        kernel = kernel.permute(0, 1, 3, 2)
        if self.use_spectral_norm:
            kernel = self.sn(kernel)
        dt = self.dtype or folded.dtype
        weight = kernel.permute(3, 2, 0, 1).to(dt)  # (in, out, kh, kw)
        y = F.conv_transpose2d(folded.to(dt).permute(0, 3, 1, 2), weight,
                               stride=self.strides, padding=self.pad)
        y = y.permute(0, 2, 3, 1)
        y = y + bias.to(y.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return _unfold(y, x.shape[0])


class _BatchNormParams(nn.Module):
    """Flax ``nn.BatchNorm``'s variables: params scale/bias, batch_stats
    mean/var."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))


class TimeBatchNorm(nn.Module):
    """Inference BatchNorm over (B, T, H, W) per channel, epsilon 1e-3."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn = _BatchNormParams(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        folded = _fold(x).to(dt).permute(0, 3, 1, 2)
        bn = self.bn
        y = F.batch_norm(folded, bn.mean, bn.var, bn.scale, bn.bias,
                         training=False, eps=1e-3)
        return _unfold(y.permute(0, 2, 3, 1), x.shape[0])


class ConvLSTM(nn.Module):
    """ConvLSTM2D over (B, T, H, W, C) -> (B, T, H, W, features).

    Keras recurrence: gate order (i, f, c, o), hard_sigmoid (or sigmoid)
    recurrent activation, tanh cell activation, unit forget bias.  The
    input conv for all steps runs as one folded ``F.conv2d``; the
    recurrence runs in :func:`windtpu_torch.ops.convlstm.convlstm_seq`."""

    def __init__(self, in_features: int, features: int,
                 recurrent_activation: str = "hard_sigmoid",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = features
        self.features = f
        self.hard_sig = recurrent_activation == "hard_sigmoid"
        self.dtype = dtype
        self.input_conv = _ConvParams((3, 3, in_features, 4 * f), 4 * f)
        self.recurrent_kernel = nn.Parameter(torch.empty(3, 3, f, 4 * f))
        self.forget_bias = nn.Parameter(torch.empty(f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        dt = self.dtype or x.dtype
        zx = conv2d_nhwc(_fold(x).to(dt), self.input_conv.kernel.to(dt))
        zx = zx + self.input_conv.bias.to(dt)
        fb = self.forget_bias.to(dt)
        zeros = torch.zeros(f, dtype=dt, device=fb.device)
        zx = zx + torch.cat([zeros, fb, zeros, zeros])
        zx = _unfold(zx, x.shape[0]).contiguous()
        return convlstm_seq(zx, self.recurrent_kernel, hard_sig=self.hard_sig)


def bilinear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D(size=2, interpolation='bilinear') on
    (B, T, H, W, C), half-pixel centres."""
    folded = _fold(x).permute(0, 3, 1, 2)
    y = F.interpolate(folded, scale_factor=2, mode="bilinear",
                      align_corners=False)
    return _unfold(y.permute(0, 2, 3, 1), x.shape[0])
