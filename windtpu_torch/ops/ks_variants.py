"""Time variants of the spatial-KS kernel on the card.

Builds copies of ``csrc/spatial_ks.cu`` with other block shapes (WARPS,
ROWS, and MIN_BLOCKS, the least number of resident blocks per SM given
to ``__launch_bounds__``, 0 for none) and with passes cut out, and times each at the
training step's shape (96 field pairs of 96 x 96, patch 9, 100 thresholds).  The cut
variants compute wrong results by design; their times split the kernel's
time by pass: ``index only`` leaves the loads, the threshold search and the
write, ``no horizontal`` adds the vertical pass.  Run it on a card::

    python3 -m windtpu_torch.ops.ks_variants
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from windtpu_torch.metrics.metrics import spatially_convolved_ks_stat
from windtpu_torch.ops._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from windtpu_torch.ops.ks import _ARGTYPES, ascending_thresholds

# (WARPS, ROWS, MIN_BLOCKS, cut); the first is the source as it is, the
# second the same without a least number of blocks (ptxas then takes fewer
# registers).
VARIANTS = [(4, 16, 1, ""), (4, 16, 0, ""), (4, 16, 6, ""), (8, 16, 4, ""), (8, 16, 5, ""),
            (4, 32, 3, ""), (2, 16, 10, ""), (4, 16, 1, "no horizontal"),
            (4, 16, 1, "index only")]
CUTS = {"no horizontal": ("if (len > 0) {", "if (len > 0 && k0b < 0) {"),
        "index only": ("item < strips * parts;", "item < 0;")}


def _build(variant):
    warps, rows, min_blocks, cut = variant
    src = (CSRC_DIR / "spatial_ks.cu").read_text()
    bound = f"THREADS, {min_blocks}" if min_blocks else "THREADS"
    edits = [("constexpr int WARPS = 4;", f"constexpr int WARPS = {warps};"),
             ("constexpr int ROWS = 16;", f"constexpr int ROWS = {rows};"),
             ("__launch_bounds__(THREADS, 1)", f"__launch_bounds__({bound})")]
    if cut:
        edits.append(CUTS[cut])
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"ks_w{warps}_r{rows}_m{min_blocks}_{cut.replace(' ', '_')}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=True)
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    return so, regs


def main() -> None:
    with ThreadPoolExecutor(len(VARIANTS)) as pool:   # one nvcc per variant
        built = list(pool.map(_build, VARIANTS))
    rng = np.random.default_rng(60)
    shape = (2, 24, 96, 96, 2)
    real = 8.0 * rng.standard_normal(shape, dtype=np.float32)
    fake = real + 4.0 * rng.standard_normal(shape, dtype=np.float32)
    real, fake = torch.from_numpy(real).cuda(), torch.from_numpy(fake).cuda()
    points = ascending_thresholds(100, -30.0, 30.0, real.device)
    want = spatially_convolved_ks_stat(real, fake, 9, 100)
    out = torch.empty((96, 88, 88), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for variant, (so, regs) in zip(VARIANTS, built):
        fn = ctypes.CDLL(str(so)).windtpu_spatial_ks
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int

        def call():
            return fn(real.data_ptr(), 0, fake.data_ptr(), 0,
                      points.data_ptr(), out.data_ptr(), 96, 2, 96, 96, 9,
                      100, stream)

        if call():
            raise RuntimeError(f"{variant}: launch failed")
        torch.cuda.synchronize()
        err = (out.mean(dim=0) - want).abs().max().item()
        times = []
        for _ in range(3):
            for _ in range(3):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 50)
        warps, rows, min_blocks, cut = variant
        print(f"WARPS {warps} ROWS {rows} MIN_BLOCKS {min_blocks} "
              f"{cut or 'whole kernel'}: registers {'/'.join(regs)}, "
              f"max_abs_err {err:.2e}, ms "
              f"{' '.join(f'{t:.4f}' for t in times)}", flush=True)


if __name__ == "__main__":
    main()
