"""Building blocks of the generator and the critic, in PyTorch.

Counterparts of ``windtpu/models/layers.py``.  The public layout is the JAX
package's: fields are ``(B, T, H, W, C)``, kernels are stored as HWIO
``(kh, kw, in, out)`` under the same names as the flax variables, so a flax
checkpoint loads by renaming alone (:mod:`windtpu_torch.weights`).  Inside,
time folds into the batch axis and each convolution runs on an NCHW view
of the NHWC data (a channels-last tensor, so no copy).

Semantics kept from the JAX layers:

* spectral normalization is one power step off the stored ``u``, on the
  kernel matricized as ``reshape(-1, out)``; the step itself carries no
  gradient, and ``u`` moves only when the layer is called with
  ``update_sn_stats=True`` (training); the transpose conv normalizes in TF
  layout ``(kh, kw, out, in)``, so its ``u`` lives in the in-channel space;
* the transpose conv has Keras semantics: ``F.conv_transpose2d`` with the
  HWIO kernel permuted to ``(in, out, kh, kw)`` and no flip;
* BatchNorm and LayerNorm epsilon 1e-3, BatchNorm momentum 0.99 (Keras);
* the ConvLSTM hoists the input conv over all steps and folds the unit
  forget bias into it.  Which recurrence it then runs is fixed where the
  model is built: the generator's layer is built on
  :func:`windtpu_torch.ops.convlstm.convlstm_seq` (the CUDA kernel), the
  critic's layers on :func:`convlstm_scan` (op by op, differentiable any
  number of times, as the gradient penalty needs).  Nothing chooses at run
  time.

State moves only when a layer is called with its training flag
(``update_sn_stats=True``, ``train=True``); ``nn.Module.training`` is not
read.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from windtpu_torch.ops.convlstm import hard_sigmoid

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
    ``u`` (shape ``(out,)``, the kernel's last axis).  The power step is
    taken in f32 and carries no gradient: sigma is differentiable through
    the kernel only.  ``u`` is a buffer; it is overwritten with the step's
    result when ``update_stats`` is set."""

    def __init__(self, out_features: int):
        super().__init__()
        self.register_buffer("u", torch.empty(out_features))

    def forward(self, kernel: torch.Tensor,
                update_stats: bool = False) -> torch.Tensor:
        w = kernel.reshape(-1, kernel.shape[-1]).float()
        with torch.no_grad():
            v = _l2_normalize(w @ self.u)
            u_new = _l2_normalize(v @ w)
        sigma = torch.einsum("i,io,o->", v.to(kernel.dtype),
                             w.to(kernel.dtype), u_new.to(kernel.dtype))
        if update_stats:
            # v and u_new are fresh tensors, so overwriting u leaves every
            # graph built so far (also the twice-differentiated one) valid.
            self.u.copy_(u_new)
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

    def forward(self, x: torch.Tensor,
                update_sn_stats: bool = False) -> torch.Tensor:
        folded = _fold(x)
        if self.use_spectral_norm:
            kernel = self.sn(self.kernel, update_sn_stats)
            bias = self.bias
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

    def forward(self, x: torch.Tensor,
                update_sn_stats: bool = False) -> torch.Tensor:
        folded = _fold(x)
        if self.use_spectral_norm:
            kernel, bias = self.kernel, self.bias
        else:
            kernel, bias = self.conv.kernel, self.conv.bias
        # TF Conv2DTranspose layout (kh, kw, out, in): spectral norm is
        # taken in it so that u lives in the in-channel space.
        kernel = kernel.permute(0, 1, 3, 2)
        if self.use_spectral_norm:
            kernel = self.sn(kernel, update_sn_stats)
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
    """BatchNorm over (B, T, H, W) per channel, epsilon 1e-3.

    ``train=False`` normalizes with the running statistics.  ``train=True``
    normalizes with the batch's own mean and biased variance, taken in f32
    whatever the compute dtype (``E[x^2] - E[x]^2``, floored at 0), lets the
    gradient flow through them, and moves the running statistics by
    ``ra = 0.99 * ra + 0.01 * batch`` with that same biased variance."""

    momentum = 0.99
    eps = 1e-3

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn = _BatchNormParams(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bn = self.bn
        if not train:
            folded = _fold(x).to(dt).permute(0, 3, 1, 2)
            y = F.batch_norm(folded, bn.mean, bn.var, bn.scale, bn.bias,
                             training=False, eps=self.eps)
            return _unfold(y.permute(0, 2, 3, 1), x.shape[0])
        xf = x.float()
        dims = (0, 1, 2, 3)
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            bn.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            bn.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * bn.scale) + bn.bias
        return y.to(dt)


class _LayerNormParams(nn.Module):
    """Flax ``nn.LayerNorm``'s params scale/bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))


class KerasLayerNorm(nn.Module):
    """LayerNormalization over the channel axis, epsilon 1e-3."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln = _LayerNormParams(features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return F.layer_norm(x.to(dt), (x.shape[-1],), self.ln.scale.to(dt),
                            self.ln.bias.to(dt), eps=1e-3)


def convlstm_scan(zx: torch.Tensor, rk: torch.Tensor, *,
                  hard_sig: bool = True) -> torch.Tensor:
    """The ConvLSTM recurrence op by op in ``zx.dtype``, over pre-biased
    gate activations ``zx`` (B, T, H, W, 4F) with the recurrent kernel
    ``rk`` (kh, kw, F, 4F); returns the hidden sequence (B, T, H, W, F).

    Plain differentiable PyTorch, any number of times: the critic's
    recurrences run on it (they sit inside the twice-differentiated
    gradient penalty), and the backward of the generator's kernel replays
    it.  h_{-1} = 0, so the first step has no recurrent product."""
    f = rk.shape[2]
    dt = zx.dtype
    rk = rk.to(dt)
    act = hard_sigmoid if hard_sig else torch.sigmoid
    h_prev = c_prev = None
    ys = []
    for s in range(zx.shape[1]):
        z = zx[:, s]
        if h_prev is not None:
            z = z + conv2d_nhwc(h_prev, rk)
        zi, zf, zc, zo = z.split(f, dim=-1)
        c = act(zi) * torch.tanh(zc)
        if c_prev is not None:
            c = act(zf) * c_prev + c
        h_prev, c_prev = act(zo) * torch.tanh(c), c
        ys.append(h_prev)
    return torch.stack(ys, dim=1)


Recurrence = Callable[..., torch.Tensor]


class ConvLSTMParams(nn.Module):
    """The parameters of one ConvLSTM under flax's names
    (``input_conv/{kernel,bias}``, ``recurrent_kernel``, ``forget_bias``),
    without its computation, so that a critic built with
    :func:`fused_dual_convlstm` shares checkpoints with one built from two
    :class:`ConvLSTM` layers."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        f = features
        self.features = f
        self.input_conv = _ConvParams((3, 3, in_features, 4 * f), 4 * f)
        self.recurrent_kernel = nn.Parameter(torch.empty(3, 3, f, 4 * f))
        self.forget_bias = nn.Parameter(torch.empty(f))

    def tensors(self):
        return (self.input_conv.kernel, self.input_conv.bias,
                self.recurrent_kernel, self.forget_bias)


class ConvLSTM(ConvLSTMParams):
    """ConvLSTM2D over (B, T, H, W, C) -> (B, T, H, W, features).

    Keras recurrence: gate order (i, f, c, o), hard_sigmoid (or sigmoid)
    recurrent activation, tanh cell activation, unit forget bias.  The
    input conv for all steps runs as one folded ``F.conv2d``; the
    recurrence is the function the layer was built on, ``recurrence(zx, rk,
    hard_sig=...)``: :func:`windtpu_torch.ops.convlstm.convlstm_seq` or
    :func:`convlstm_scan`."""

    def __init__(self, in_features: int, features: int, *,
                 recurrence: Recurrence,
                 recurrent_activation: str = "hard_sigmoid",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, features)
        self.recurrence = recurrence
        self.hard_sig = recurrent_activation == "hard_sigmoid"
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        dt = self.dtype or x.dtype
        zx = conv2d_nhwc(_fold(x).to(dt), self.input_conv.kernel.to(dt))
        zx = zx + self.input_conv.bias.to(dt)
        fb = self.forget_bias.to(dt)
        zeros = torch.zeros(f, dtype=dt, device=fb.device)
        zx = zx + torch.cat([zeros, fb, zeros, zeros])
        zx = _unfold(zx, x.shape[0]).contiguous()
        return self.recurrence(zx, self.recurrent_kernel,
                               hard_sig=self.hard_sig)


def fused_dual_convlstm(x: torch.Tensor, span_a: Tuple[int, int],
                        span_b: Tuple[int, int], params_a, params_b, *,
                        recurrent_activation: str = "hard_sigmoid"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independent ConvLSTMs over channel spans of one input stack, run
    as ONE :func:`convlstm_scan` with block-structured kernels.

    ``x`` is (B, T, H, W, C); branch A reads channels
    ``span_a[0]:span_a[1]``, branch B ``span_b[0]:span_b[1]``;
    ``params_a``/``params_b`` are :meth:`ConvLSTMParams.tensors` tuples.
    The fused kernels carry zero blocks where one branch would read the
    other's channels, so the result is that of the two separate layers.
    The fused gate layout is per-gate-contiguous, [i_a i_b | f_a f_b |
    c_a c_b | o_a o_b].  Returns the hidden sequences (B, T, H, W, f_a)
    and (B, T, H, W, f_b)."""
    ik_a, ib_a, rk_a, fb_a = params_a
    ik_b, ib_b, rk_b, fb_b = params_b
    fa, fb_n = rk_a.shape[2], rk_b.shape[2]
    ftot = fa + fb_n
    kh, kw = rk_a.shape[:2]
    dt = x.dtype

    def blocks(k_a, k_b, rows_a, rows_b, rows):
        """(kh, kw, rows, 4*ftot) from the two per-branch kernels."""
        out = torch.zeros((kh, kw, rows, 4 * ftot), dtype=torch.float32,
                          device=k_a.device)
        for g in range(4):
            out[:, :, rows_a[0]:rows_a[1], g * ftot:g * ftot + fa] = \
                k_a[:, :, :, g * fa:(g + 1) * fa]
            out[:, :, rows_b[0]:rows_b[1], g * ftot + fa:(g + 1) * ftot] = \
                k_b[:, :, :, g * fb_n:(g + 1) * fb_n]
        return out

    ik = blocks(ik_a, ik_b, span_a, span_b, x.shape[-1])
    rk = blocks(rk_a, rk_b, (0, fa), (fa, ftot), ftot)
    gate_bias = torch.cat([
        torch.cat([ib_a[g * fa:(g + 1) * fa],
                   ib_b[g * fb_n:(g + 1) * fb_n]]) for g in range(4)])
    zeros = torch.zeros(ftot, dtype=fb_a.dtype, device=fb_a.device)
    fb_vec = torch.cat([zeros, fb_a, fb_b, zeros, zeros])
    zx = conv2d_nhwc(_fold(x), ik.to(dt)) + (gate_bias + fb_vec).to(dt)
    out = convlstm_scan(_unfold(zx, x.shape[0]), rk,
                        hard_sig=recurrent_activation == "hard_sigmoid")
    return out[..., :fa], out[..., fa:]


class _DenseParams(nn.Module):
    """Flax ``nn.Dense``'s params: kernel (in, out) and bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))


class TimeDense(nn.Module):
    """Dense over the last axis of (B, T, in)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = _DenseParams(in_features, features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        return x.to(dt) @ self.dense.kernel.to(dt) + self.dense.bias.to(dt)


def shortcut_geometry(in_size: int, target: int) -> Tuple[int, int, int]:
    """(stride, padding, kernel) so that one conv maps ``in_size`` ->
    ``target``: aligns a residual branch with the output of a conv
    pyramid."""
    if target == 1:
        return 1, 0, in_size
    strides = -(-(2 + in_size) // (target - 1))  # ceil
    margin = 2
    padding = -(-(strides * (target - 1) - in_size) // 2) + 1 + margin
    kernel = strides * (1 - target) + in_size + 2 * padding
    return strides, padding, kernel


class ShortcutConv(nn.Module):
    """Strided SN conv + LayerNorm that aligns a hi-res residual of
    spatial size ``in_size`` to ``target_size``."""

    def __init__(self, in_features: int, features: int, in_size: int,
                 target_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        strides, padding, kernel = shortcut_geometry(in_size, target_size)
        self.conv = TimeConv(in_features, features, (kernel, kernel),
                             strides=(strides, strides), padding=padding,
                             use_spectral_norm=True, dtype=dtype)
        self.norm = KerasLayerNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor,
                update_sn_stats: bool = False) -> torch.Tensor:
        return self.norm(self.conv(x, update_sn_stats))


@torch.no_grad()
def init_variables(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model``'s parameters and buffers from ``seed`` with Keras'
    initialisers by variable name: Glorot-uniform kernels, orthogonal
    recurrent kernels, zero biases, unit scales and forget bias, unit
    running variance, Gaussian spectral-norm ``u``."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:-1])
            fan_out = math.prod(p.shape[:-2]) * p.shape[-1]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            p.copy_(torch.rand(p.shape, generator=gen) * 2 * lim - lim)
        elif leaf == "recurrent_kernel":
            rows, cols = math.prod(p.shape[:-1]), p.shape[-1]
            a = torch.randn(max(rows, cols), min(rows, cols), generator=gen)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            p.copy_((q if rows >= cols else q.T).reshape(p.shape))
        elif leaf in ("scale", "forget_bias"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, buf in model.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "u":
            buf.copy_(torch.randn(buf.shape, generator=gen))
        elif leaf == "var":
            buf.fill_(1.0)
        else:
            buf.zero_()
    return model


def bilinear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D(size=2, interpolation='bilinear') on
    (B, T, H, W, C), half-pixel centres."""
    folded = _fold(x).permute(0, 3, 1, 2)
    y = F.interpolate(folded, scale_factor=2, mode="bilinear",
                      align_corners=False)
    return _unfold(y.permute(0, 2, 3, 1), x.shape[0])
