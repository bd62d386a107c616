"""ConvLSTM recurrence: the hand-written CUDA kernel and its plain version.

:func:`convlstm_seq` is the port of the TPU kernel
``windtpu/ops/pallas_convlstm.py:convlstm_seq_fused``: pre-biased gate
activations ``zx`` (B, T, H, W, 4F) and a recurrent kernel ``rk``
(3, 3, F, 4F) in, the hidden-state sequence (B, T, H, W, F) out.  On a CUDA
tensor it launches ``csrc/convlstm.cu`` once per time step; on a CPU tensor
it runs :func:`convlstm_seq_plain`, the same arithmetic in plain PyTorch
with the same rounding points (f32 accumulation and gate math, h and c
stored in the I/O dtype between steps).  There is no fallback from the
kernel to the plain version.  The gradient comes from
:class:`ConvLSTMSeqFunction`, whose backward replays the recurrence.

The kernel library is built and bound at first use by
:mod:`windtpu_torch.ops._build`; nothing is compiled or loaded when this
module is imported.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from windtpu_torch.ops._build import bind

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard_sigmoid: clip(0.2*x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _check(zx: torch.Tensor, rk: torch.Tensor) -> int:
    """Validate what the kernel takes; returns F."""
    if zx.dim() != 5 or zx.shape[-1] % 4:
        raise ValueError(
            f"convlstm expects zx of shape (B, T, H, W, 4F); got "
            f"{tuple(zx.shape)}")
    f = zx.shape[-1] // 4
    if tuple(rk.shape) != (3, 3, f, 4 * f):
        raise ValueError(
            f"convlstm requires a (3, 3, F, 4F) recurrent kernel; got "
            f"{tuple(rk.shape)} for F={f}")
    if zx.dtype not in _DTYPE_CODES:
        raise TypeError(f"convlstm takes float32 or bfloat16 zx; got "
                        f"{zx.dtype}")
    if not zx.is_contiguous():
        raise ValueError("convlstm requires a contiguous zx")
    if rk.device != zx.device:
        raise ValueError(f"zx is on {zx.device} but rk is on {rk.device}")
    return f


def convlstm_seq_plain(zx: torch.Tensor, rk: torch.Tensor, *,
                       hard_sig: bool = True) -> torch.Tensor:
    """Plain PyTorch recurrence with the kernel's signature and rounding:
    a loop over t of ``F.conv2d`` in f32 plus the gate math in f32, with
    h and c rounded to ``zx.dtype`` after every step."""
    f = _check(zx, rk)
    b, t, h, w, _ = zx.shape
    dt = zx.dtype
    act = hard_sigmoid if hard_sig else torch.sigmoid
    # (4F, F, 3, 3); rounded to the I/O dtype first, as the kernel sees it.
    weight = rk.to(dt).float().permute(3, 2, 0, 1)
    c = torch.zeros((b, h, w, f), dtype=torch.float32, device=zx.device)
    h_prev = None
    ys = []
    for s in range(t):
        z = zx[:, s].float()
        if h_prev is not None:
            zh = F.conv2d(h_prev.float().permute(0, 3, 1, 2), weight,
                          padding=1)
            z = z + zh.permute(0, 2, 3, 1)
        zi, zf, zc, zo = z.split(f, dim=-1)
        c_new = act(zf) * c + act(zi) * torch.tanh(zc)
        h_new = act(zo) * torch.tanh(c_new)
        c = c_new.to(dt).float()
        h_prev = h_new.to(dt)
        ys.append(h_prev)
    return torch.stack(ys, dim=1)


_STEP_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _launch_sequence(zx: torch.Tensor, rk: torch.Tensor,
                     hard_sig: bool) -> torch.Tensor:
    """T launches of the step kernel on ``zx``'s device and current stream."""
    step = bind("convlstm", "windtpu_convlstm_step", _STEP_ARGTYPES)
    b, t, h, w, f4 = zx.shape
    f = f4 // 4
    rk = rk.to(zx.dtype).contiguous()
    y = torch.empty((b, t, h, w, f), dtype=zx.dtype, device=zx.device)
    c = torch.empty((b, h, w, f), dtype=zx.dtype, device=zx.device)
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(t):
            err = step(_DTYPE_CODES[zx.dtype], zx.data_ptr(), rk.data_ptr(),
                       y.data_ptr(), c.data_ptr(), b, t, h, w, f, s,
                       int(hard_sig), stream)
            if err:
                raise RuntimeError(
                    f"convlstm kernel launch failed at step {s}: CUDA error "
                    f"{err}")
            convlstm_seq.launches += 1
    return y


class ConvLSTMSeqFunction(torch.autograd.Function):
    """The recurrence with the kernel as its forward.  The backward does
    what the TPU kernel's custom VJP does (``_make_fused`` in
    ``windtpu/ops/pallas_convlstm.py``): it replays the op-by-op recurrence
    ``models.layers.convlstm_scan`` on the saved inputs and takes that
    replay's gradient.  It can be differentiated once; the twice
    differentiated path (the critic's gradient penalty) is built on
    ``convlstm_scan`` itself."""

    @staticmethod
    def forward(ctx, zx, rk, hard_sig):
        ctx.save_for_backward(zx, rk)
        ctx.hard_sig = hard_sig
        if zx.device.type == "cpu":
            return convlstm_seq_plain(zx, rk, hard_sig=hard_sig)
        return _launch_sequence(zx, rk, hard_sig)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        # Lazy import: models.layers imports this module.
        from windtpu_torch.models.layers import convlstm_scan

        zx, rk = (a.detach().requires_grad_() for a in ctx.saved_tensors)
        with torch.enable_grad():
            y = convlstm_scan(zx, rk, hard_sig=ctx.hard_sig)
        wanted = [a for a, need in zip((zx, rk), ctx.needs_input_grad)
                  if need]
        grads = iter(torch.autograd.grad(y, wanted, grad.to(y.dtype)))
        return tuple(next(grads) if need else None
                     for need in ctx.needs_input_grad[:2]) + (None,)


def convlstm_seq(zx: torch.Tensor, rk: torch.Tensor, *,
                 hard_sig: bool = True) -> torch.Tensor:
    """ConvLSTM sequence: (B, T, H, W, 4F), (3, 3, F, 4F) -> (B, T, H, W, F).

    ``zx`` carries the input conv with the gate bias and the unit forget
    bias folded in.  CUDA tensors launch the kernel (T launches, counted in
    ``convlstm_seq.launches``) through :class:`ConvLSTMSeqFunction`, which
    gives the gradients for ``zx`` and ``rk``; CPU tensors take the plain
    version under ordinary autograd."""
    _check(zx, rk)
    if zx.device.type == "cpu":
        return convlstm_seq_plain(zx, rk, hard_sig=hard_sig)
    if zx.device.type != "cuda":
        raise ValueError(f"convlstm runs on CUDA or CPU tensors; got "
                         f"{zx.device}")
    return ConvLSTMSeqFunction.apply(zx, rk, hard_sig)


convlstm_seq.launches = 0
