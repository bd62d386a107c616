"""Spatially-convolved KS statistic: the hand-written CUDA kernel's wrapper.

:func:`spatial_ks` is the port of the TPU kernel
``windtpu/ops/pallas_ks.py:spatial_ks_pallas``: ``real`` and ``fake``
(B, T, H, W, C) in, the mean KS image (OH, OW) over all B*T*C field pairs
out.  On CUDA tensors it launches ``csrc/spatial_ks.cu`` once, on the
tensors as they are (f32 or bf16; other float types are cast to f32 first),
and averages its per-pair images; on CPU tensors it runs the plain version,
:func:`windtpu_torch.metrics.metrics.spatially_convolved_ks_stat`.  The
kernel compares each value with the thresholds once, as the index of the
first threshold it does not exceed.  There is no fallback from the kernel
to the plain version, and no gradient: the metric is computed on detached
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from windtpu_torch.metrics.metrics import (
    ks_thresholds,
    spatially_convolved_ks_stat,
)
from windtpu_torch.ops._build import bind
from windtpu_torch.utils.logging import span

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def spatial_ks(real: torch.Tensor, fake: torch.Tensor,
               patch_size: Optional[int] = None, num_points: int = 100,
               lo: float = -30.0, hi: float = 30.0) -> torch.Tensor:
    """Mean KS image (OH, OW) over all (batch, time, channel) fields of
    ``real`` and ``fake`` (B, T, H, W, C), any float type.  ``patch_size``
    defaults to ``fake.shape[2] // 10``.  CUDA tensors launch the kernel
    (one launch, counted in ``spatial_ks.launches``); CPU tensors take the
    plain version."""
    if real.dim() != 5 or real.shape != fake.shape:
        raise ValueError(
            f"spatial_ks expects two (B, T, H, W, C) tensors of one shape; "
            f"got {tuple(real.shape)} and {tuple(fake.shape)}")
    if fake.device != real.device:
        raise ValueError(f"real is on {real.device} but fake is on "
                         f"{fake.device}")
    if not (real.is_floating_point() and fake.is_floating_point()):
        raise TypeError(f"spatial_ks takes float tensors; got {real.dtype} "
                        f"and {fake.dtype}")
    patch_size = patch_size or fake.shape[2] // 10
    h, w = real.shape[2], real.shape[3]
    if not 1 <= patch_size <= min(h, w):
        raise ValueError(f"patch_size {patch_size} does not fit a "
                         f"{h} x {w} field")
    if num_points < 1:
        raise ValueError(f"num_points must be positive; got {num_points}")
    real, fake = real.detach(), fake.detach()
    with span("ops.k2"):
        if real.device.type == "cpu":
            return spatially_convolved_ks_stat(real, fake, patch_size,
                                               num_points, lo, hi)
        if real.device.type != "cuda":
            raise ValueError(f"spatial_ks runs on CUDA or CPU tensors; got "
                             f"{real.device}")
        real, fake = (x if x.dtype in _DTYPE_CODES else x.float()
                      for x in (real, fake))
        b, t, _, _, c = real.shape
        out = torch.empty((b * t * c, h - patch_size + 1,
                           w - patch_size + 1),
                          dtype=torch.float32, device=real.device)
        launch_spatial_ks(real.contiguous(), fake.contiguous(),
                          ascending_thresholds(num_points, lo, hi,
                                               real.device),
                          out, patch_size)
        return torch.mean(out, dim=0)


spatial_ks.launches = 0


@functools.lru_cache(maxsize=16)
def ascending_thresholds(num_points: int, lo: float, hi: float,
                         device: torch.device) -> torch.Tensor:
    """The plain version's thresholds in ascending order, as the kernel's
    binary search needs them; made once per (num_points, lo, hi, device).
    For lo > hi that is the same set reversed, and the max over the set is
    the same."""
    points = ks_thresholds(num_points, lo, hi, device)
    return points.flip(0) if lo > hi else points


def launch_spatial_ks(real: torch.Tensor, fake: torch.Tensor,
                      points: torch.Tensor, out: torch.Tensor,
                      patch_size: int) -> None:
    """One launch of the kernel: ``real`` and ``fake`` (B, T, H, W, C)
    contiguous CUDA tensors, each f32 or bf16; ascending f32 ``points``;
    the per-pair KS images ``out`` (B*T*C, H-patch+1, W-patch+1) f32.
    Counted in ``spatial_ks.launches``."""
    kernel = bind("spatial_ks", "windtpu_spatial_ks", _ARGTYPES)
    b, t, h, w, c = real.shape
    with torch.cuda.device(real.device):
        err = kernel(real.data_ptr(), _DTYPE_CODES[real.dtype],
                     fake.data_ptr(), _DTYPE_CODES[fake.dtype],
                     points.data_ptr(), out.data_ptr(), b * t * c, c, h, w,
                     patch_size, points.numel(),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spatial_ks kernel launch failed: CUDA error "
                           f"{err}")
    spatial_ks.launches += 1
