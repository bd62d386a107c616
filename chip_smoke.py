#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``windtpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which ends the script with a nonzero exit on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: compile every kernel of the main path from ``windtpu_torch/ops/csrc``
   with nvcc, print the compile seconds and ``-Xptxas -v``;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main path's shape (bf16 and f32) and at a ragged shape, then time
   the kernel, the plain version and the nearest PyTorch library call with
   CUDA events, beside the kernel's bound;
4. reference: the flagship network in f32 with the bundled weights on a
   small domain, on the card (kernels) against the CPU (plain versions);
5. main path: ``windtpu_torch.api.downscale`` of the flagship inference
   domain (24 h, 546 x 756 px, 63 patches) with the bundled generator and
   texture gate; checks the output and that every kernel launched, times
   one call after a warm-up, and profiles one more call;
6. one JSON line with the kernels, then the result line.

It imports nothing of JAX or of the ``windtpu`` package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN_SHAPE = (16, 24, 24, 24, 128)   # (B, T, H, W, F) of the generator's K1
RAGGED_SHAPE = (3, 5, 7, 7, 40)
TOL = {"bfloat16": 2.0 ** -5, "float32": 1e-4}
# The f32 flagship network on the card vs the CPU, output in m/s.
REFERENCE_TOL = 2e-3

KERNELS = [{
    "name": "convlstm_seq",
    "route": "cuda",
    "source": "windtpu_torch/ops/csrc/convlstm.cu",
    "replaces": "windtpu/ops/pallas_convlstm.py:196",
}]


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def build_all():
    from windtpu_torch.ops import convlstm

    info = convlstm.build_library()
    print(f"convlstm_seq: {info.path.name} built={info.built} "
          f"nvcc {info.seconds:.1f} s")
    print(info.log.strip())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
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


def convlstm_inputs(shape, dtype, seed: int):
    import torch

    b, t, h, w, f = shape
    rng = np.random.default_rng(seed)
    zx = rng.standard_normal((b, t, h, w, 4 * f), dtype=np.float32)
    rk = 0.1 * rng.standard_normal((3, 3, f, 4 * f), dtype=np.float32)
    return (torch.from_numpy(zx).to("cuda", dtype),
            torch.from_numpy(rk).to("cuda"))


def convlstm_bound(shape, itemsize: int):
    """Least time of one sequence: the T-1 recurrent 3x3 convs on the tensor
    cores (bf16 peak; h_{-1} = 0, so step 0 has none) vs zx read once, rk
    read once, y written once."""
    b, t, h, w, f = shape
    flops = 2.0 * b * (t - 1) * h * w * 9 * f * 4 * f
    nbytes = itemsize * (b * t * h * w * 5 * f + 9 * f * 4 * f)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from windtpu_torch.ops.convlstm import convlstm_seq, convlstm_seq_plain

    cases = [(MAIN_SHAPE, torch.bfloat16, True),
             (MAIN_SHAPE, torch.float32, True),
             (RAGGED_SHAPE, torch.bfloat16, True),
             (RAGGED_SHAPE, torch.float32, False)]
    main_err = None
    for i, (shape, dtype, hard) in enumerate(cases):
        zx, rk = convlstm_inputs(shape, dtype, seed=i)
        got = convlstm_seq(zx, rk, hard_sig=hard)
        want = convlstm_seq_plain(zx, rk, hard_sig=hard)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[str(dtype).split(".")[-1]]
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        print(f"convlstm_seq {shape} {dtype} hard_sig={hard}: max_abs_err "
              f"{err:.3e} (tol {tol:.1e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"convlstm_seq disagrees with its plain version at {shape} "
                 f"{dtype}")
        if i == 0:
            main_err = err

    zx, rk = convlstm_inputs(MAIN_SHAPE, torch.bfloat16, seed=0)
    b, t, h, w, f = MAIN_SHAPE
    ms = cuda_ms(lambda: convlstm_seq(zx, rk), iters=20)
    plain_ms = cuda_ms(lambda: convlstm_seq_plain(zx, rk), iters=5, warmup=1)
    # Library yardstick, conv part only: the T-1 recurrent 3x3 convs as
    # cuDNN calls on channels-last bf16 (no single PyTorch call computes
    # the whole recurrence).
    hx = torch.randn(b, f, h, w, device="cuda", dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last)
    wk = rk.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        for _ in range(t - 1):
            F.conv2d(hx, wk, padding=1)

    library_ms = cuda_ms(library, iters=20)
    bound_ms, bound_by, flops, nbytes = convlstm_bound(MAIN_SHAPE, 2)
    print(f"convlstm_seq {MAIN_SHAPE} bf16, one sequence ({t} launches): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (cuDNN "
          f"conv part only) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
          f"kernel at {flops / ms / 1e9:.1f} TFLOP/s")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def era5_and_dem(nlat: int, nlon: int, nt: int, seed: int,
                 lat0: float = 47.0, lon0: float = 5.0):
    """An in-memory ERA5 day on a 0.25 deg grid (latitude descending) and
    a DEM raster covering it, both from ``seed``."""
    from windtpu_torch.io.dataset import DataArray, Dataset

    rng = np.random.default_rng(seed)
    lat = lat0 - 0.25 * np.arange(nlat)
    lon = lon0 + 0.25 * np.arange(nlon)
    time_ = (np.datetime64("2016-04-01T00", "h")
             + np.arange(nt).astype("timedelta64[h]"))
    dims = ("time", "latitude", "longitude")
    era5 = Dataset(
        {"u10": DataArray(dims, (3.0 + rng.standard_normal(
            (nt, nlat, nlon))).astype(np.float32)),
         "v10": DataArray(dims, rng.standard_normal(
             (nt, nlat, nlon)).astype(np.float32))},
        {"time": DataArray(("time",), time_),
         "latitude": DataArray(("latitude",), lat),
         "longitude": DataArray(("longitude",), lon)})
    # 0.01 deg DEM: a coarse random relief upsampled 10x, plus roughness.
    ny, nx = 10 * (nlat + 2), 10 * (nlon + 2)
    coarse = 700.0 * rng.standard_normal((nlat + 2, nlon + 2))
    dem = 1500.0 + np.kron(coarse, np.ones((10, 10))) \
        + 50.0 * rng.standard_normal((ny, nx))
    y = lat[0] + 0.25 - 0.01 * (np.arange(ny) + 0.5)
    x = lon[0] - 0.25 + 0.01 * (np.arange(nx) + 0.5)
    raster = Dataset(
        {"band_data": DataArray(("band", "y", "x"),
                                dem[None].astype(np.float32))},
        {"band": DataArray(("band",), np.array([1])),
         "y": DataArray(("y",), y), "x": DataArray(("x",), x)})
    return era5, raster


def reference_phase() -> float:
    import dataclasses

    from windtpu_torch import api
    from windtpu_torch.network import WindDownscalingGAN

    cfg = api.flagship_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    era5, raster = era5_and_dem(8, 9, 24, seed=1)
    outs = {}
    for dev in ("cuda", "cpu"):
        net = WindDownscalingGAN(cfg, device=dev)
        net.load_weights(api.BUNDLED_GENERATOR)
        t0 = time.perf_counter()
        res = api.downscale(era5, raster, network=net, noise_std=0.0,
                            texture_gate=False, device=dev)
        outs[dev] = np.stack([res["u10"].values, res["v10"].values])
        print(f"reference {dev}: {outs[dev].shape} in "
              f"{time.perf_counter() - t0:.2f} s")
    a, b = outs["cuda"], outs["cpu"]
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        fail("card and CPU outputs differ in their NaN cells")
    err = float(np.nanmax(np.abs(a - b)))
    print(f"reference: f32 flagship, card vs CPU max_abs_err {err:.3e} "
          f"(tol {REFERENCE_TOL:.0e}, output scale "
          f"{float(np.nanmax(np.abs(b))):.2f})")
    if not np.isfinite(a[~np.isnan(a)]).all() or err > REFERENCE_TOL:
        fail("the card's f32 downscale disagrees with the CPU's")
    return err


def main_path_phase() -> dict:
    import torch

    from windtpu_torch import api
    from windtpu_torch.ops.convlstm import convlstm_seq

    # The flagship inference domain (InferenceConfig): 24 h on 21 x 42
    # ERA5 cells -> 546 x 756 px, 63 patches in 4 groups of 16.
    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    network = api.get_network()
    api.downscale(era5, raster, network=network)  # warm-up
    torch.cuda.synchronize()

    counts = {"convlstm_seq": 0}
    convlstm_seq.launches = 0
    t0 = time.perf_counter()
    res = api.downscale(era5, raster, network=network)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["convlstm_seq"] = convlstm_seq.launches

    u, v = res["u10"].values, res["v10"].values
    want = (24, 546 - 4, 756 - 4)
    if set(res.data_vars) != {"u10", "v10"} or u.shape != want \
            or v.shape != want:
        fail(f"output {sorted(res.data_vars)} {u.shape} != u10/v10 {want}")
    if res["u10"].dims != ("time", "lat_1", "lon_1"):
        fail(f"output dims {res['u10'].dims}")
    if not (np.isfinite(u).all() and np.isfinite(v).all()):
        fail("downscaled output is not finite")
    groups, seq = 4, 24
    if counts["convlstm_seq"] != groups * seq:
        fail(f"convlstm_seq launched {counts['convlstm_seq']} times, "
             f"expected {groups} generator calls x {seq} steps")
    print(f"downscale 24 h x 546 x 756 (63 patches): {seconds:.3f} s, "
          f"{63 / seconds:.1f} patches/s, convlstm_seq launches "
          f"{counts['convlstm_seq']}, u10 std {float(np.std(u)):.3f}")

    profile_downscale(lambda: api.downscale(era5, raster, network=network))
    profile_host(lambda: api.downscale(era5, raster, network=network))
    return counts


def profile_host(fn) -> None:
    """Host time by function of the port over one more call (cProfile;
    cumulative seconds, which include the device waits inside them)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [(ct, f"{Path(file).name}:{func}")
            for (file, _, func), (_, _, _, ct, _)
            in pstats.Stats(prof).stats.items()
            if "windtpu_torch" in file]
    print(f"host profile: wall {wall * 1e3:.1f} ms under cProfile")
    for ct, name in sorted(rows, reverse=True)[:12]:
        print(f"  {ct * 1e3:9.1f} ms  {name}")


def profile_downscale(fn) -> None:
    """Device time by kernel over one more call, and the device's busy
    share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(r[1] for r in rows)
    if not rows:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile: wall {wall * 1e3:.1f} ms, device kernels "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "windtpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(windtpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("device")
    smi = device_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase("build")
    build_all()
    phase("kernels")
    stats = kernel_phase()
    phase("reference")
    reference_phase()
    phase("main path")
    counts = main_path_phase()

    kernels = [{**k, "launches": counts[k["name"]], **stats}
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
