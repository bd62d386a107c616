"""LayerNorm over the last axis: hand-written CUDA kernels for the forward,
the backward and the double backward, and their plain versions.

:func:`layer_norm` is ``F.layer_norm(x, (N,), gamma, beta, eps)`` with the
statistics and the arithmetic in float32 (float64 for a float64 ``x``) and
the result in ``x.dtype``.  It replaces no TPU kernel: the JAX package
leaves flax's LayerNorm to XLA.  ATen's CUDA layer norm launches one block
of threads per row, and the critic normalises over as few as 16 channels
(1.77 M rows at its 96 px maps), where those kernels ran 27 to 55 times
their byte bound; ``csrc/layer_norm.cu`` holds a row in a few lanes'
registers instead.

Three autograd Functions, built like :mod:`windtpu_torch.ops.conv2d_grad`:
:class:`_LayerNorm`, whose backward is :class:`_LayerNormBackward`, whose
backward is the double backward (differentiable no further).  A backward
computes only the gradients the running backward pass uses: the gradient
penalty's first backward, taken for the image alone, reduces no gamma or
beta gradient.  On a CUDA tensor each stage launches its kernel (float32 or
bfloat16, N up to 256 or 512; counted in ``layer_norm.launches``, none
while a CUDA graph captures) or raises; on a CPU tensor the same chain runs
on the plain stages :func:`forward_plain`, :func:`backward_plain` and
:func:`double_backward_plain`.  Nothing is compiled or loaded when this
module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd import Function
from torch.autograd.function import once_differentiable

from windtpu_torch.ops._build import bind
from windtpu_torch.ops.conv2d_grad import _wanted

Tensor = torch.Tensor
Grads = Tuple[Optional[Tensor], Optional[Tensor], Optional[Tensor]]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A row is at most 32 lanes x 2 vectors; a vector is 16 bytes where N and
# the pointers allow, else one element (csrc/layer_norm.cu, by_vectors).
MAX_VECTORS = 64
# Blocks a kernel's persistent grid may hold per SM (2048 threads of 256):
# the rows of partial sums the wrapper allocates.
BLOCKS_PER_SM = 8
_SMS = {}   # device index: its multiprocessor count

_P, _I = ctypes.c_void_p, ctypes.c_int
_HEAD = [_I, _I, ctypes.c_longlong, _I]   # dtype, w, rows, n
_FORWARD_ARGTYPES = _HEAD + [ctypes.c_float] + [_P] * 7
_BACKWARD_ARGTYPES = _HEAD + [_P] * 9 + [_I, _P]
_DOUBLE_ARGTYPES = _HEAD + [_P] * 12 + [_I, _P]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rows(t: Tensor) -> Tensor:
    return t.reshape(-1, t.shape[-1])


def forward_plain(x: Tensor, gamma: Tensor, beta: Tensor,
                  eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, mean, rstd): y in ``x.dtype``; mean and rstd of the rows, shape
    ``x.shape[:-1]``, in the arithmetic dtype."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(-1)
    xc = xf - mean[..., None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    y = xc * rstd[..., None] * gamma.to(acc) + beta.to(acc)
    return y.to(x.dtype), mean, rstd


def backward_plain(dy: Tensor, x: Tensor, gamma: Tensor, mean: Tensor,
                   rstd: Tensor, want: Tuple[bool, bool, bool]) -> Grads:
    """(dx, dgamma, dbeta) of :func:`forward_plain` for the output gradient
    ``dy``, each None where ``want`` says so."""
    acc = mean.dtype
    r = rstd[..., None]
    d = dy.to(acc)
    xh = (x.to(acc) - mean[..., None]) * r
    dx = dgamma = dbeta = None
    if want[0]:
        g = d * gamma.to(acc)
        a = g.mean(-1, keepdim=True)
        b = (g * xh).mean(-1, keepdim=True)
        dx = (r * (g - a - xh * b)).to(x.dtype)
    if want[1]:
        dgamma = _rows(d * xh).sum(0).to(gamma.dtype)
    if want[2]:
        dbeta = _rows(d).sum(0).to(gamma.dtype)
    return dx, dgamma, dbeta


def double_backward_plain(dy: Tensor, x: Tensor, gamma: Tensor, mean: Tensor,
                          rstd: Tensor, ggx: Optional[Tensor],
                          ggg: Optional[Tensor], ggb: Optional[Tensor],
                          want: Tuple[bool, bool, bool]) -> Grads:
    """(gdy, gx, ggamma): the gradients of ``dy``, ``x`` and ``gamma`` of
    :func:`backward_plain`'s (dx, dgamma, dbeta) for their gradients
    (ggx, ggg, ggb), a None among which reads as zero; each None where
    ``want`` says so."""
    acc = mean.dtype
    r = rstd[..., None]
    d = dy.to(acc)
    gam = gamma.to(acc)
    xh = (x.to(acc) - mean[..., None]) * r
    g = d * gam
    z = torch.zeros_like(xh) if ggx is None else ggx.to(acc)
    g3 = torch.zeros_like(gam) if ggg is None else ggg.to(acc)
    c = z.mean(-1, keepdim=True)
    q = (z * xh).mean(-1, keepdim=True)
    h = r * (z - c - xh * q)
    gdy = gx = ggamma = None
    if want[0]:
        gdy = gam * h + g3 * xh
        if ggb is not None:
            gdy = gdy + ggb.to(acc)
        gdy = gdy.to(dy.dtype)
    if want[1]:
        a = g.mean(-1, keepdim=True)
        b = (g * xh).mean(-1, keepdim=True)
        p = (z * g).mean(-1, keepdim=True)
        gd = g3 * d
        e = gd.mean(-1, keepdim=True)
        f = (gd * xh).mean(-1, keepdim=True)
        gx = (r * (gd - e) - r * r * (q * (g - a) + b * (z - c))
              + xh * (r * r * (3 * b * q - p + a * c) - r * f)).to(x.dtype)
    if want[2]:
        ggamma = _rows(d * h).sum(0).to(gamma.dtype)
    return gdy, gx, ggamma


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _width(x: Tensor, *tensors: Optional[Tensor]) -> int:
    """Elements per vector for rows of ``x``: 16 bytes where N and every
    pointer allow, else 1.  Raises on what the kernels do not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm's kernels take float32 or bfloat16; "
                        f"got {x.dtype}")
    n = x.shape[-1]
    vec = 16 // x.element_size()
    w = vec if n % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, *tensors) if t is not None) else 1
    if n > MAX_VECTORS * w:
        raise ValueError(
            f"layer_norm's kernels take rows of up to {MAX_VECTORS * vec} "
            f"{x.dtype} elements in a multiple of {vec}, or {MAX_VECTORS} "
            f"otherwise; got {n}")
    return w


def _scratch(x: Tensor, arrays: int) -> Tuple[Optional[Tensor], int]:
    """Partial sums for ``arrays`` per-channel gradients, and the blocks
    they have room for; (None, 0) for none."""
    if not arrays:
        return None, 0
    sms = _SMS.get(x.device.index)
    if sms is None:
        sms = _SMS[x.device.index] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
    cap = sms * BLOCKS_PER_SM
    return (torch.empty(arrays * cap * x.shape[-1], dtype=torch.float32,
                        device=x.device), cap)


def _launch(stage: str, symbol: str, argtypes, x: Tensor, w: int,
            launches: int, *args) -> None:
    """One call of the C entry ``symbol`` for the rows of ``x`` on its
    device's current stream; raises on its error code.  Its ``launches``
    are counted in ``layer_norm.launches`` unless a CUDA graph captures the
    stream: a replay launches the graph's kernels without this wrapper."""
    entry = bind("layer_norm", symbol, argtypes)
    n = x.shape[-1]
    args = (_DTYPE_CODES[x.dtype], w, x.numel() // n, n, *args)
    if x.device.index == torch.cuda.current_device():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = entry(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"layer_norm {stage} kernel launch failed: CUDA "
                           f"error {err}")
    if not torch.cuda.is_current_stream_capturing():
        layer_norm.launches += launches


def _forward(x: Tensor, gamma: Tensor, beta: Tensor, eps: float,
             stats: bool):
    """The forward stage on ``x``'s device: (y, mean, rstd), the last two
    None unless ``stats``."""
    if x.device.type == "cpu":
        y, mean, rstd = forward_plain(x, gamma, beta, eps)
        return (y, mean, rstd) if stats else (y, None, None)
    w = _width(x, gamma, beta)
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty(x.shape[:-1], dtype=torch.float32,
                                  device=x.device) for _ in "mr")
    if y.numel():
        _launch("forward", "windtpu_layer_norm_forward", _FORWARD_ARGTYPES,
                x, w, 1, eps, x.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), y.data_ptr(), _ptr(mean), _ptr(rstd))
    return y, mean, rstd


def _backward(dy: Tensor, x: Tensor, gamma: Tensor, mean: Tensor,
              rstd: Tensor, want: Tuple[bool, bool, bool]) -> Grads:
    """The backward stage on ``x``'s device (``dy`` and ``x`` contiguous)."""
    if x.device.type == "cpu":
        return backward_plain(dy, x, gamma, mean, rstd, want)
    w = _width(x, dy, gamma)
    dx = torch.empty_like(x) if want[0] else None
    dgamma, dbeta = (torch.empty_like(gamma) if k else None
                     for k in want[1:])
    sums = want[1] or want[2]
    if x.numel():
        part, cap = _scratch(x, 2 if sums else 0)
        _launch("backward", "windtpu_layer_norm_backward",
                _BACKWARD_ARGTYPES, x, w, 1 + sums, dy.data_ptr(),
                x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                gamma.data_ptr(), _ptr(dx), _ptr(dgamma), _ptr(dbeta),
                _ptr(part), cap)
    elif sums:
        dgamma, dbeta = (None if t is None else t.zero_()
                         for t in (dgamma, dbeta))
    return dx, dgamma, dbeta


def _double_backward(dy: Tensor, x: Tensor, gamma: Tensor, mean: Tensor,
                     rstd: Tensor, ggx: Optional[Tensor],
                     ggg: Optional[Tensor], ggb: Optional[Tensor],
                     want: Tuple[bool, bool, bool]) -> Grads:
    """The double-backward stage on ``x``'s device (``ggx`` contiguous)."""
    if x.device.type == "cpu":
        return double_backward_plain(dy, x, gamma, mean, rstd, ggx, ggg, ggb,
                                     want)
    w = _width(x, dy, gamma, ggx, ggg, ggb)
    gdy = torch.empty_like(dy) if want[0] else None
    gx = torch.empty_like(x) if want[1] else None
    ggamma = torch.empty_like(gamma) if want[2] else None
    if x.numel():
        part, cap = _scratch(x, int(want[2]))
        _launch("double backward", "windtpu_layer_norm_double_backward",
                _DOUBLE_ARGTYPES, x, w, 1 + want[2], dy.data_ptr(),
                x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                gamma.data_ptr(), _ptr(ggx), _ptr(ggg), _ptr(ggb), _ptr(gdy),
                _ptr(gx), _ptr(ggamma), _ptr(part), cap)
    elif want[2]:
        ggamma.zero_()
    return gdy, gx, ggamma


class _LayerNorm(Function):
    """y = layer_norm(x, gamma, beta); saves the rows' mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = _forward(x, gamma, beta, eps, stats=True)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        want = tuple(_wanted(ctx, i) for i in range(3))
        if not any(want):
            return None, None, None, None
        dy = dy.contiguous()
        if torch.is_grad_enabled():
            grads = _LayerNormBackward.apply(dy, x, gamma, mean, rstd, *want)
        else:
            grads = _backward(dy, x, gamma, mean, rstd, want)
        return (*grads, None)


class _LayerNormBackward(Function):
    """(dx, dgamma, dbeta) of :class:`_LayerNorm` for ``dy``, None where
    not wanted; its backward is the double-backward stage."""

    @staticmethod
    def forward(ctx, dy, x, gamma, mean, rstd, want_x, want_gamma,
                want_beta):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dy, x, gamma, mean, rstd)
        return _backward(dy, x, gamma, mean, rstd,
                         (want_x, want_gamma, want_beta))

    @staticmethod
    @once_differentiable
    def backward(ctx, ggx, ggg, ggb):
        dy, x, gamma, mean, rstd = ctx.saved_tensors
        want = tuple(_wanted(ctx, i) for i in range(3))
        if not any(want) or (ggx is None and ggg is None and ggb is None):
            return (None,) * 8
        if ggx is not None:
            ggx = ggx.contiguous()
        grads = _double_backward(dy, x, gamma, mean, rstd, ggx, ggg, ggb,
                                 want)
        return (*grads, None, None, None, None, None)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor,
               eps: float) -> Tensor:
    """``F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)`` for ``x``,
    ``gamma`` and ``beta`` of one dtype on one device (CPU or CUDA),
    differentiable twice; see the module's docstring."""
    n = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(gamma.shape) != (n,) \
            or tuple(beta.shape) != (n,):
        raise ValueError(f"layer_norm takes x (..., N) with gamma and beta "
                         f"(N,); got {tuple(x.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(beta.shape)}")
    if not x.dtype == gamma.dtype == beta.dtype:
        raise TypeError(f"layer_norm takes one dtype; got {x.dtype}, "
                        f"{gamma.dtype}, {beta.dtype}")
    if x.device.type not in ("cpu", "cuda") or not (
            x.device == gamma.device == beta.device):
        raise ValueError(f"layer_norm runs on CUDA or CPU tensors of one "
                         f"device; got {x.device}, {gamma.device}, "
                         f"{beta.device}")
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma.contiguous(), beta.contiguous(),
                                float(eps))
    return _forward(x, gamma.contiguous(), beta.contiguous(), float(eps),
                    stats=False)[0]


layer_norm.launches = 0
