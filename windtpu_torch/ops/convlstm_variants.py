"""Time variants of the ConvLSTM kernel's two routes on the card.

Builds copies of ``csrc/convlstm.cu`` with edits and times each with the
tiles and clusters the C entry builds, through its one-call sequence entry.

bf16 (``wgmma``): other ring lengths (STAGES 2, 6), no ``setmaxnreg``, and
passes cut out (the products, the slab's TMA loads, the halo windows' TMA
loads, the whole K loop, the epilogue's gate math and stores), each with
clusters of 1, 2 and 4
blocks sharing the slab, at the bf16 paths' shapes: the downscale (16, 24,
24, 24, 128), the 4-member ensemble (64, 24, 24, 24, 128) and the training
step (2, 24, 24, 24, 128); the source as it is also with every tile.  For
each build it prints registers, spills, the HGMMA count in the SASS and
ptxas's wgmma serialisation warnings.

f32 (CUDA cores): another stage depth BK, ring length STAGES_F32, register
budget, loop order, or a pass cut out, each timed with every tile and split
the C entry builds, at the f32 paths' shapes: train_main (16, 6, 8, 8,
128), one of its two ranks (8, 6, 8, 8, 128), the perceptual train_main
(2, 24, 24, 24, 128) and the downscale (16, 24, 24, 24, 128).  For each
build it prints the registers and spills of the F % 4 == 0 kernels and,
from ``cuobjdump -sass``, the share of FFMAs that read two registers of the
same parity from the register file (a bank conflict on Hopper's two banks).

Each variant is first held against the plain version at a small shape (the
cut variants compute wrong results by design: their times split the
kernel's).  Run it on a card, both routes or one::

    python3 -m windtpu_torch.ops.convlstm_variants [bf16|f32]
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from windtpu_torch.ops._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from windtpu_torch.ops.convlstm import (
    _SEQ_ARGTYPES,
    BF16_BUILT,
    BF16_CLUSTERS,
    F32_CHUNK,
    TILES as BF16_TILES,
    choose_tile,
    convlstm_seq_plain,
    launch_sequence,
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
F32_VARIANTS = {
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
F32_TILES = [(64, 32, 1), (64, 32, 3), (32, 32, 1), (32, 32, 3)]
F32_SHAPES = [(16, 6, 8, 8, 128), (8, 6, 8, 8, 128),
              (2, 24, 24, 24, 128), (16, 24, 24, 24, 128)]


_LOAD_B = "tma_load_3d_multicast(dst, &w_map, full_b(s), c0, n0, z, mask);"
_LOAD_B1 = "tma_load_3d(dst, &w_map, full_b(s), c0, n0, z);"
# name -> edits of the source (every occurrence); the first is the source as
# it is.  The cuts keep every barrier's arrivals and bytes consistent.
BF16_VARIANTS = {
    "as is": [],
    "STAGES 2": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "STAGES 6": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "no setmaxnreg": [("setmaxnreg_dec<40>();", ";"),
                      ("setmaxnreg_inc<232>();", ";")],
    "cut: the products": [("wgmma_tile<C::BN>(acc, a[kk], desc[kk]);", "")],
    "cut: the K loop": [("const int KT = t > 0 ? 9 * chunks : 0;",
                         "const int KT = 0;")],
    "cut: the gate math and stores": [
        ("            if (!in_m[half] || j >= F) continue;",
         "            if (Tn > 0 || !in_m[half] || j >= F) continue;")],
    "cut: the slab loads": [
        ("mbar_expect_tx(full_b(s), C::B_BYTES);",
         "mbar_expect_tx(full_b(s), 0);"),
        (_LOAD_B, ""), (_LOAD_B1, "")],
    "cut: the halo windows": [
        ("mbar_expect_tx(full_a(s), boxes * C::P * ROW_BYTES);",
         "mbar_expect_tx(full_a(s), 0);"),
        ("for (int i = 0; i < boxes; ++i) {",
         "for (int i = 0; i < 0; ++i) {")],
}
BF16_SHAPES = [(16, 24, 24, 24, 128), (64, 24, 24, 24, 128),
               (2, 24, 24, 24, 128)]


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


def _compile(name, edits, route):
    """Build the source with ``edits`` applied (each to every occurrence);
    returns the library and nvcc's log."""
    src = (CSRC_DIR / "convlstm.cu").read_text()
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (f"convlstm_{route}_" + re.sub(r"\W+", "_", name) + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=True)
    return so, proc.stdout + proc.stderr


def _build(item):
    name, (bk, edits) = item
    so, log = _compile(name, edits, "f32")
    # Registers and spill bytes of each F % 4 == 0 f32 kernel.
    regs = re.findall(r"convlstm_step_f32INS_7F32TileILi(\d+)ELi32EEELi(\d)"
                      r"ELb1[^\n]*\n[^\n]*\n\s+\d+ bytes stack frame, (\d+) "
                      r"bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
                      log)
    return so, regs, _ffma_clashes(so)


def _build_bf16(item):
    """The library, and per bf16 kernel (CW, BJ, VEC): registers, spill
    bytes, HGMMA count; and the number of wgmma serialisation warnings."""
    name, edits = item
    so, log = _compile(name, edits, "bf16")
    kernels = {}
    for cw, bj, vec, spill, regs in re.findall(
            r"convlstm_step_wgmmaINS_4TileILi(\d)ELi(\d+)EEELb(\d)[^\n]*\n"
            r"[^\n]*\n\s+\d+ bytes stack frame, (\d+) bytes spill stores"
            r"[^\n]*\n[^\n]*Used (\d+) registers", log):
        kernels[cw, bj, vec] = [int(regs), int(spill), 0]
    for (cw, bj, vec), count in hgmma_counts(so).items():
        if (cw, bj, vec) in kernels:
            kernels[cw, bj, vec][2] = count
    return so, kernels, len(re.findall(r"C75\d\d", log))


def hgmma_counts(so):
    """{(CW, BJ, VEC): HGMMA instructions} of the bf16 kernels in ``so``,
    from its SASS (empty without cuobjdump)."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\S*convlstm_step_wgmmaINS_4TileILi(\d)ELi(\d+)EEELb"
                     r"(\d)", fn)
        if m:
            out[m.groups()] = len(re.findall(r"\bHGMMA\.", fn))
    return out


def _sequence(entry, zx, rk, bm, bj, cluster):
    return launch_sequence(entry, zx, rk, True, bm, bj, cluster)


def _entry(so):
    entry = getattr(ctypes.CDLL(str(so)), "windtpu_convlstm_seq")
    entry.argtypes = list(_SEQ_ARGTYPES)
    entry.restype = ctypes.c_int
    return entry


def _inputs(shapes, dtype):
    inputs = {}
    for i, shape in enumerate(shapes):
        b, t, h, w, f = shape
        rng = np.random.default_rng(i)
        zx = rng.standard_normal((b, t, h, w, 4 * f), dtype=np.float32)
        rk = 0.1 * rng.standard_normal((3, 3, f, 4 * f), dtype=np.float32)
        inputs[shape] = (torch.from_numpy(zx).to("cuda", dtype),
                         torch.from_numpy(rk).cuda())
    return inputs


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


def f32_main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(len(F32_VARIANTS)) as pool:
        built = list(pool.map(_build, F32_VARIANTS.items()))
    inputs = _inputs(F32_SHAPES, torch.float32)
    zx, rk = inputs[F32_SHAPES[0]]
    want = convlstm_seq_plain(zx, rk)
    for (name, (bk, _)), (so, regs, clashes) in zip(F32_VARIANTS.items(),
                                                    built):
        entry = _entry(so)
        info = ", ".join(
            f"{bm}/{split}: {r} regs {spill} B spill, FFMA clashes "
            f"{clashes.get((int(bm), int(split)), (0, float('nan')))[1]:.2f}"
            for bm, split, spill, r in regs)
        print(f"f32 {name} ({info})")
        for bm, bj, split in F32_TILES:
            run = _sequence_bk(entry, bk, bm, bj, split)
            got = run(zx, rk)
            err = (got - want).abs().max().item()
            times = [_ms(lambda: run(*inputs[shape])) for shape in F32_SHAPES]
            print(f"  BM {bm} x BJ {bj}, split {split}: max_abs_err "
                  f"{err:.2e}; ms " + ", ".join(
                      f"{shape}: {ms:.4f}" for shape, ms in zip(F32_SHAPES,
                                                                  times)),
                  flush=True)


def _sequence_bk(entry, bk, bm, bj, split):
    """The f32 sequence with a slab packed for stage depth ``bk`` (a
    variant's BK, which launch_sequence would not pack for)."""

    def run(zx, rk):
        b, t, h, w, f4 = zx.shape
        slab = pack_recurrent_kernel(rk, bj, bk)
        y = torch.empty((b, t, h, w, f4 // 4), dtype=zx.dtype,
                        device=zx.device)
        c = torch.empty((b, h, w, f4 // 4), dtype=zx.dtype, device=zx.device)
        failed = ctypes.c_int(0)
        err = entry(0, zx.data_ptr(), slab.data_ptr(), y.data_ptr(),
                    c.data_ptr(), None, b, t, h, w, f4 // 4, 1, bm, bj, bk,
                    split, torch.cuda.current_stream().cuda_stream,
                    ctypes.byref(failed))
        if err:
            raise RuntimeError(f"launch failed at step {failed.value}: CUDA "
                               f"error {err}")
        return y
    return run


def bf16_main() -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with ThreadPoolExecutor(len(BF16_VARIANTS)) as pool:
        built = list(pool.map(_build_bf16, BF16_VARIANTS.items()))
    inputs = _inputs(BF16_SHAPES, torch.bfloat16)
    zx, rk = _inputs([(2, 4, 24, 24, 128)], torch.bfloat16)[
        (2, 4, 24, 24, 128)]
    want = convlstm_seq_plain(zx, rk)
    for name, (so, kernels, warnings) in zip(BF16_VARIANTS, built):
        entry = _entry(so)
        info = ", ".join(
            f"CW {cw} BJ {bj}{'' if vec == '1' else ' F%8'}: {r} regs, "
            f"{spill} B spill, {hg} HGMMA"
            for (cw, bj, vec), (r, spill, hg) in sorted(kernels.items()))
        print(f"bf16 {name} ({info}; {warnings} wgmma serialisation "
              f"warnings)")
        for bm, bj in sorted(BF16_BUILT, reverse=True):
            rule = [BF16_TILES[choose_tile(s[0] * s[2] * s[3], s[4], sms)][:2]
                    for s in BF16_SHAPES]
            if name != "as is" and (bm, bj) not in rule:
                continue
            for cluster in BF16_CLUSTERS:
                got = _sequence(entry, zx, rk, bm, bj, cluster)
                err = (got.float() - want.float()).abs().max().item()
                times = [
                    _ms(lambda: _sequence(entry, *inputs[shape], bm, bj,
                                          cluster))
                    if (name == "as is" or rule[i] == (bm, bj)) else None
                    for i, shape in enumerate(BF16_SHAPES)]
                print(f"  BM {bm} x BJ {bj}, cluster {cluster}: max_abs_err "
                      f"{err:.2e}; ms " + ", ".join(
                          f"{shape}: {ms:.4f}" for shape, ms in
                          zip(BF16_SHAPES, times) if ms is not None),
                      flush=True)


def main() -> None:
    routes = sys.argv[1:] or ["bf16", "f32"]
    for route in routes:
        {"bf16": bf16_main, "f32": f32_main}[route]()


if __name__ == "__main__":
    main()
