"""Build and bind the kernels under ``ops/csrc/``.

Each source is one ``.cu`` file with a plain C interface.  It is compiled
with ``nvcc`` for ``sm_90a`` at first use into ``build/windtpu_torch/``
under the checkout, keyed by a hash of the source and the flags, and loaded
with ``ctypes``.  Nothing is compiled or loaded when a module is imported.
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
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "windtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` into a shared library unless a library
    for this exact source and these flags is already there."""
    source_path = CSRC_DIR / f"{name}.cu"
    source = source_path.read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}_{key[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, log, 0.0, False)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path.name} "
                           f"({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(lib, log, seconds, True)


_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}


def bind(name: str, symbol: str, argtypes: Sequence[type]):
    """The C function ``symbol`` of ``csrc/<name>.cu``, built and loaded on
    the first call.  It returns the launch's ``cudaGetLastError()`` code."""
    fn = _FUNCTIONS.get(symbol)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(name).path)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[symbol] = fn
    return fn
