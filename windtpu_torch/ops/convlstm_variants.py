"""Time variants of the ConvLSTM kernel's f32 route on the card.

Builds copies of ``csrc/convlstm.cu`` with edits (another stage depth BK,
ring length STAGES_F32, register budget, loop order, or a pass cut out),
and times each with every tile and split the C entry builds, at the f32
paths' shapes: train_main (16, 6, 8, 8, 128), one of its two ranks
(8, 6, 8, 8, 128), the perceptual train_main (2, 24, 24, 24, 128) and the
downscale (16, 24, 24, 24, 128).  Each variant is first held against the
plain version at train_main's shape (the cut variants compute wrong
results by design: their times split the kernel's).  For each build it
prints the registers and spills of the F % 4 == 0 kernels and, from
``cuobjdump -sass``, the share of FFMAs that read two registers of the same
parity from the register file (a bank conflict on Hopper's two banks).
Run it on a card::

    python3 -m windtpu_torch.ops.convlstm_variants
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from windtpu_torch.ops._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from windtpu_torch.ops.convlstm import (
    _STEP_ARGTYPES,
    F32_CHUNK,
    convlstm_seq_plain,
    pack_recurrent_kernel,
)

_REGS = "MIN_BLOCKS = 384 / THREADS;  // at most 170 registers"
_FMA = "acc[i][g][q] = fmaf(a, lane4(bv[g], q), acc[i][g][q]);"
_A = "const float a = lane4(a4[i], s);"
_A_SCALAR = "const float a = As[(ty + i * C::TY) * C::AS + kq + s];"
_ORDER = """          for (int i = 0; i < TM; ++i) {
            const float a = lane4(a4[i], s);
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
              for (int q = 0; q < TJ; ++q)
                acc[i][g][q] = fmaf(a, lane4(bv[g], q), acc[i][g][q]);
          }"""
_ORDER_B = """          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int q = 0; q < TJ; ++q)
#pragma unroll
              for (int i = 0; i < TM; ++i)
                acc[i][g][q] = fmaf(lane4(a4[i], s), lane4(bv[g], q),
                                    acc[i][g][q]);"""
# name -> (BK, edits of the source); the first is the source as it is.
VARIANTS = {
    "as is": (F32_CHUNK, []),
    "<= 128 registers": (F32_CHUNK, [(_REGS, "MIN_BLOCKS = 512 / THREADS;")]),
    "<= 255 registers": (F32_CHUNK, [(_REGS, "MIN_BLOCKS = 256 / THREADS;")]),
    "B operand innermost": (F32_CHUNK, [(_ORDER, _ORDER_B)]),
    "A by scalar loads": (F32_CHUNK, [(_A, _A_SCALAR)]),
    "STAGES_F32 2": (F32_CHUNK, [("constexpr int STAGES_F32 = 3;",
                                  "constexpr int STAGES_F32 = 2;")]),
    "STAGES_F32 4": (F32_CHUNK, [("constexpr int STAGES_F32 = 3;",
                                  "constexpr int STAGES_F32 = 4;")]),
    "BK 8": (8, [("constexpr int BK = 16;", "constexpr int BK = 8;")]),
    "BK 32": (32, [("constexpr int BK = 16;", "constexpr int BK = 32;")]),
    "cut: B once per kq": (F32_CHUNK, [
        ("Bs + (kq + s) * C::BN + g * C::BJ", "Bs + kq * C::BN + g * C::BJ")]),
    "cut: half the FFMAs": (F32_CHUNK, [
        (_FMA, "if (q < 2) " + _FMA)]),
}
TILES = [(64, 32, 1), (64, 32, 3), (32, 32, 1), (32, 32, 3)]
SHAPES = [(16, 6, 8, 8, 128), (8, 6, 8, 8, 128), (2, 24, 24, 24, 128),
          (16, 24, 24, 24, 128)]


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    return path if os.path.exists(path) else None


def _ffma_clashes(so):
    """{(BM, split): (FFMAs, share with two same-parity register reads)}
    of the F % 4 == 0 f32 kernels, from their SASS."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*convlstm_step_f32INS_7F32TileILi(\d+)ELi32EEELi(\d)"
                     r"ELb1", fn)
        if not m:
            continue
        n = clash = 0
        for ops in re.findall(r"FFMA R\d+, (R\d+(?:\.reuse)?), "
                              r"(R\d+(?:\.reuse)?), (R\d+(?:\.reuse)?)", fn):
            read = [int(o[1:].split(".")[0]) for o in ops if "reuse" not in o]
            n += 1
            clash += len({r % 2 for r in read}) < len(read)
        out[int(m.group(1)), int(m.group(2))] = (n, clash / max(n, 1))
    return out


def _build(item):
    name, (bk, edits) = item
    src = (CSRC_DIR / "convlstm.cu").read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("convlstm_" + re.sub(r"\W+", "_", name) + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=True)
    log = proc.stdout + proc.stderr
    # Registers and spill bytes of each F % 4 == 0 f32 kernel.
    regs = re.findall(r"convlstm_step_f32INS_7F32TileILi(\d+)ELi32EEELi(\d)"
                      r"ELb1[^\n]*\n[^\n]*\n\s+\d+ bytes stack frame, (\d+) "
                      r"bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
                      log)
    return so, regs, _ffma_clashes(so)


def _sequence(step, zx, rk, bm, bj, bk, split):
    b, t, h, w, f4 = zx.shape
    f = f4 // 4
    packed = pack_recurrent_kernel(rk, bj, bk)
    y = torch.empty((b, t, h, w, f), dtype=zx.dtype, device=zx.device)
    c = torch.empty((b, h, w, f), dtype=zx.dtype, device=zx.device)
    stream = torch.cuda.current_stream().cuda_stream
    for s in range(t):
        err = step(0, zx.data_ptr(), packed.data_ptr(), y.data_ptr(),
                   c.data_ptr(), b, t, h, w, f, s, 1, bm, bj, bk, split,
                   stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return y


def _ms(fn, iters=10):
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(_build, VARIANTS.items()))
    inputs = {}
    for i, shape in enumerate(SHAPES):
        b, t, h, w, f = shape
        rng = np.random.default_rng(i)
        zx = rng.standard_normal((b, t, h, w, 4 * f), dtype=np.float32)
        rk = 0.1 * rng.standard_normal((3, 3, f, 4 * f), dtype=np.float32)
        inputs[shape] = (torch.from_numpy(zx).cuda(),
                         torch.from_numpy(rk).cuda())
    zx, rk = inputs[SHAPES[0]]
    want = convlstm_seq_plain(zx, rk)
    for (name, (bk, _)), (so, regs, clashes) in zip(VARIANTS.items(), built):
        step = getattr(ctypes.CDLL(str(so)), "windtpu_convlstm_step")
        step.argtypes = list(_STEP_ARGTYPES)
        step.restype = ctypes.c_int
        info = ", ".join(
            f"{bm}/{split}: {r} regs {spill} B spill, FFMA clashes "
            f"{clashes.get((int(bm), int(split)), (0, float('nan')))[1]:.2f}"
            for bm, split, spill, r in regs)
        print(f"{name} ({info})")
        for bm, bj, split in TILES:
            got = _sequence(step, zx, rk, bm, bj, bk, split)
            err = (got - want).abs().max().item()
            times = [_ms(lambda: _sequence(step, *inputs[shape], bm, bj, bk,
                                           split)) for shape in SHAPES]
            print(f"  BM {bm} x BJ {bj}, split {split}: max_abs_err "
                  f"{err:.2e}; ms " + ", ".join(
                      f"{shape}: {ms:.4f}" for shape, ms in zip(SHAPES,
                                                                  times)),
                  flush=True)


if __name__ == "__main__":
    main()
