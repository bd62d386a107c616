"""Spatially-convolved KS statistic: the hand-written CUDA kernel's wrapper.

:func:`spatial_ks` is the port of the TPU kernel
``windtpu/ops/pallas_ks.py:spatial_ks_pallas``: ``real`` and ``fake``
(B, T, H, W, C) in, the mean KS image (OH, OW) over all B*T*C field pairs
out.  On CUDA tensors it launches ``csrc/spatial_ks.cu`` once; on CPU
tensors it runs the plain version,
:func:`windtpu_torch.metrics.metrics.spatially_convolved_ks_stat`.  There
is no fallback from the kernel to the plain version, and no gradient: the
metric is computed on detached tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from windtpu_torch.metrics.metrics import (
    ks_fields,
    ks_thresholds,
    spatially_convolved_ks_stat,
)
from windtpu_torch.ops._build import bind

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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
    if real.device.type == "cpu":
        return spatially_convolved_ks_stat(real, fake, patch_size,
                                           num_points, lo, hi)
    if real.device.type != "cuda":
        raise ValueError(f"spatial_ks runs on CUDA or CPU tensors; got "
                         f"{real.device}")
    kernel = bind("spatial_ks", "windtpu_spatial_ks", _ARGTYPES)
    fr = ks_fields(real).contiguous()
    ff = ks_fields(fake).contiguous()
    points = ks_thresholds(num_points, lo, hi, real.device)
    n = fr.shape[0]
    out = torch.empty((n, h - patch_size + 1, w - patch_size + 1),
                      dtype=torch.float32, device=real.device)
    with torch.cuda.device(real.device):
        err = kernel(fr.data_ptr(), ff.data_ptr(), points.data_ptr(),
                     out.data_ptr(), n, h, w, patch_size, num_points,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spatial_ks kernel launch failed: CUDA error "
                           f"{err}")
    spatial_ks.launches += 1
    return torch.mean(out, dim=0)


spatial_ks.launches = 0
