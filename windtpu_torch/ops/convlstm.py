"""ConvLSTM recurrence: the hand-written CUDA kernel and its plain version.

:func:`convlstm_seq` is the port of the TPU kernel
``windtpu/ops/pallas_convlstm.py:convlstm_seq_fused``: pre-biased gate
activations ``zx`` (B, T, H, W, 4F) and a recurrent kernel ``rk``
(3, 3, F, 4F) in, the hidden-state sequence (B, T, H, W, F) out.  On a CUDA
tensor it launches ``csrc/convlstm.cu`` once per time step; on a CPU tensor
it runs :func:`convlstm_seq_plain`, the same arithmetic in plain PyTorch
with the same rounding points (f32 accumulation and gate math, h and c
stored in the I/O dtype between steps).  There is no fallback from the
kernel to the plain version.

The kernel library is compiled with ``nvcc`` at first use into
``build/windtpu_torch/`` under the checkout, keyed by a hash of the source
and flags, and bound with ``ctypes``; nothing is compiled or imported when
this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

_SOURCE = Path(__file__).resolve().parent / "csrc" / "convlstm.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "windtpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path       # the shared library
    log: str         # nvcc's output (-Xptxas -v: registers, smem, spills)
    seconds: float   # compile time; 0.0 when the cached library was used
    built: bool      # False when the library was already there


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build_library() -> BuildInfo:
    """Compile ``csrc/convlstm.cu`` into a shared library unless a library
    for this exact source and these flags is already there."""
    source = _SOURCE.read_bytes()
    key = hashlib.sha256(source + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"convlstm_{key[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, log, 0.0, False)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, log, seconds, True)


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library().path))
        fn = lib.windtpu_convlstm_step
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def convlstm_seq(zx: torch.Tensor, rk: torch.Tensor, *,
                 hard_sig: bool = True) -> torch.Tensor:
    """ConvLSTM sequence: (B, T, H, W, 4F), (3, 3, F, 4F) -> (B, T, H, W, F).

    ``zx`` carries the input conv with the gate bias and the unit forget
    bias folded in.  CUDA tensors launch the kernel (T launches, counted in
    ``convlstm_seq.launches``); CPU tensors take the plain version."""
    f = _check(zx, rk)
    if zx.device.type == "cpu":
        return convlstm_seq_plain(zx, rk, hard_sig=hard_sig)
    if zx.device.type != "cuda":
        raise ValueError(f"convlstm runs on CUDA or CPU tensors; got "
                         f"{zx.device}")
    lib = _library()
    b, t, h, w, _ = zx.shape
    rk = rk.to(zx.dtype).contiguous()
    y = torch.empty((b, t, h, w, f), dtype=zx.dtype, device=zx.device)
    c = torch.empty((b, h, w, f), dtype=zx.dtype, device=zx.device)
    with torch.cuda.device(zx.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(t):
            err = lib.windtpu_convlstm_step(
                _DTYPE_CODES[zx.dtype], zx.data_ptr(), rk.data_ptr(),
                y.data_ptr(), c.data_ptr(), b, t, h, w, f, s, int(hard_sig),
                stream)
            if err:
                raise RuntimeError(
                    f"convlstm kernel launch failed at step {s}: CUDA error "
                    f"{err}")
            convlstm_seq.launches += 1
    return y


convlstm_seq.launches = 0
