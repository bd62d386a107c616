"""Plain building blocks of the reference: convolutions, normalisations,
the ConvLSTM recurrence and the bilinear upsample on (B, T, H, W, C)
fields, written from the layer equations in plain PyTorch.

Nothing here imports the program.  Every convolution and matrix product
goes through one :class:`Precision`, so the same reference runs in float32
(the comparison) or in a lower precision (the control): ``dtype`` is the
dtype of the activations and of the products, ``quant`` a dtype each
operand of a product is rounded to first (float8 for a bfloat16 model,
with one scale per tensor; gradients pass the rounding unchanged).

Kernels are HWIO ``(kh, kw, in, out)``; a transpose kernel is HWIO too and
follows Keras (no flip).  Spectral normalisation is one power step off the
stored ``u``; BatchNorm and LayerNorm use epsilon 1e-3, BatchNorm momentum
0.99.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float32
    quant: Optional[torch.dtype] = None

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the products' dtype; with ``quant``, first rounded to
        it under one scale per tensor (its largest magnitude maps to the
        format's largest finite value), as float8 products are run."""
        if self.quant is not None:
            top = torch.finfo(self.quant).max
            with torch.no_grad():
                scale = torch.clamp(x.abs().amax().float(), min=1e-30) / top
                q = torch.clamp(x.float() / scale, -top, top)
                q = q.to(self.quant).float() * scale
            # The value rounded, the gradient passed through as it is.
            x = x + (q.to(x.dtype) - x).detach()
        return x.to(self.dtype)


FP32 = Precision()


def leaky_relu(x):
    return F.leaky_relu(x, 0.2)


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def fold(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def unfold(x, batch: int):
    return x.reshape((batch, -1) + tuple(x.shape[1:]))


def conv(x, kernel, prec: Precision, strides=(1, 1), padding="SAME"):
    """NHWC x HWIO -> NHWC. ``padding``: int, "SAME" or "VALID"."""
    xn = prec.operand(x).permute(0, 3, 1, 2)
    w = prec.operand(kernel).permute(3, 2, 0, 1)
    if padding == "VALID":
        pad = (0, 0, 0, 0)
    elif padding == "SAME":
        ph = same_pads(x.shape[1], kernel.shape[0], strides[0])
        pw = same_pads(x.shape[2], kernel.shape[1], strides[1])
        pad = (pw[0], pw[1], ph[0], ph[1])
    else:
        pad = (padding,) * 4
    y = F.conv2d(F.pad(xn, pad), w, stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


def conv_transpose(x, kernel, prec: Precision, strides=(1, 1),
                   padding="VALID"):
    """Keras Conv2DTranspose; ``kernel`` (kh, kw, in, out). VALID at any
    stride, SAME at stride 1 with odd kernels."""
    kh, kw = kernel.shape[:2]
    pad = (0, 0) if padding == "VALID" else (kh // 2, kw // 2)
    w = prec.operand(kernel).permute(2, 3, 0, 1)          # (in, out, kh, kw)
    y = F.conv_transpose2d(prec.operand(x).permute(0, 3, 1, 2), w,
                           stride=tuple(strides), padding=pad)
    return y.permute(0, 2, 3, 1)


def spectral_normalize(kernel, u, update: bool, key: str, new_state: State):
    """kernel / sigma, sigma = v^T W u' from one power step off ``u`` (no
    gradient through the step); W is the kernel as (-1, last axis)."""
    w = kernel.reshape(-1, kernel.shape[-1]).float()
    with torch.no_grad():
        v = w @ u
        v = v * torch.rsqrt(torch.sum(v * v) + 1e-12)
        u_new = v @ w
        u_new = u_new * torch.rsqrt(torch.sum(u_new * u_new) + 1e-12)
    sigma = torch.einsum("i,io,o->", v, w, u_new)
    if update:
        new_state[key] = u_new
    return kernel / sigma


def time_conv(x, p, s, name, prec, new_state, train=False, strides=(1, 1),
              padding="SAME", sn=True, act=True):
    """Time-distributed conv: ``p[name.kernel]``/``bias`` with spectral
    norm (``s[name.sn.u]``), or ``p[name.conv.kernel]``/``bias``."""
    if sn:
        kernel = spectral_normalize(p[f"{name}.kernel"], s[f"{name}.sn.u"],
                                    train, f"{name}.sn.u", new_state)
        bias = p[f"{name}.bias"]
    else:
        kernel, bias = p[f"{name}.conv.kernel"], p[f"{name}.conv.bias"]
    y = conv(fold(x), kernel, prec, strides, padding) + bias.to(prec.dtype)
    if act:
        y = leaky_relu(y)
    return unfold(y, x.shape[0])


def time_conv_transpose(x, p, s, name, prec, new_state, train=False,
                        strides=(1, 1), padding="VALID", sn=False):
    if sn:
        # Normalised in TF's (kh, kw, out, in) layout: u is in-channel.
        k = spectral_normalize(p[f"{name}.kernel"].permute(0, 1, 3, 2),
                               s[f"{name}.sn.u"], train, f"{name}.sn.u",
                               new_state).permute(0, 1, 3, 2)
        bias = p[f"{name}.bias"]
    else:
        k, bias = p[f"{name}.conv.kernel"], p[f"{name}.conv.bias"]
    y = conv_transpose(fold(x), k, prec, strides, padding)
    y = leaky_relu(y + bias.to(prec.dtype))
    return unfold(y, x.shape[0])


def batch_norm(x, p, s, name, prec, new_state, train=False):
    """Per-channel BatchNorm over (B, T, H, W). Training: the batch's mean
    and biased variance in f32 (differentiable), running stats moved by
    0.99 * ra + 0.01 * batch."""
    scale, bias = p[f"{name}.bn.scale"], p[f"{name}.bn.bias"]
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 1, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 1, 2, 3)) - mean * mean,
                          min=0.0)
        with torch.no_grad():
            new_state[f"{name}.bn.mean"] = (0.99 * s[f"{name}.bn.mean"]
                                            + 0.01 * mean)
            new_state[f"{name}.bn.var"] = (0.99 * s[f"{name}.bn.var"]
                                           + 0.01 * var)
    else:
        mean, var = s[f"{name}.bn.mean"], s[f"{name}.bn.var"]
    y = (xf - mean) * (torch.rsqrt(var + 1e-3) * scale) + bias
    return y.to(prec.dtype)


def layer_norm(x, p, name, prec):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-3) * p[f"{name}.ln.scale"] \
        + p[f"{name}.ln.bias"]
    return y.to(prec.dtype)


def convlstm(x, p, name, prec):
    """Keras ConvLSTM2D, gates (i, f, c, o), hard sigmoid, unit forget
    bias, SAME 3x3 input and recurrent convolutions, h_{-1} = c_{-1} = 0."""
    rk = p[f"{name}.recurrent_kernel"]
    f = rk.shape[2]
    zx = conv(fold(x), p[f"{name}.input_conv.kernel"], prec)
    gate_bias = p[f"{name}.input_conv.bias"] + torch.cat([
        torch.zeros_like(p[f"{name}.forget_bias"]), p[f"{name}.forget_bias"],
        torch.zeros(2 * f, dtype=rk.dtype, device=rk.device)])
    zx = unfold(zx + gate_bias.to(prec.dtype), x.shape[0])
    h = c = None
    hs = []
    for t in range(zx.shape[1]):
        z = zx[:, t]
        if h is not None:
            z = z + conv(h, rk, prec)
        zi, zf, zc, zo = z.split(f, dim=-1)
        c_new = hard_sigmoid(zi) * torch.tanh(zc)
        if c is not None:
            c_new = hard_sigmoid(zf) * c + c_new
        c = c_new
        h = hard_sigmoid(zo) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def bilinear_up2(x):
    """Keras bilinear UpSampling2D(2) with half-pixel centres; a NaN
    anywhere in a (b, t, c) input plane makes the whole output plane NaN."""
    xf = fold(x)
    bad = torch.isnan(xf.sum(dim=(1, 2), keepdim=True))
    xf = xf.masked_fill(bad, float("nan")).permute(0, 3, 1, 2)
    y = F.interpolate(xf, scale_factor=2, mode="bilinear",
                      align_corners=False)
    return unfold(y.permute(0, 2, 3, 1), x.shape[0])
