#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``windtpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which ends the script with a nonzero exit on failure:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: compile every kernel from ``windtpu_torch/ops/csrc`` with nvcc
   (one process per source, started together), print the compile seconds
   and ``-Xptxas -v``;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes and at a ragged shape, then time the kernel,
   the plain version and the nearest PyTorch call with CUDA events, beside
   the kernel's bound.  K1 (ConvLSTM): forward in bf16 and f32, and the
   gradients through its autograd Function.  K2 (spatial KS): also on
   identical fields and with NaNs;
4. reference: the flagship network in f32 with the bundled weights on a
   small domain, on the card (kernels) against the CPU (plain versions);
5. downscale path: ``windtpu_torch.api.downscale`` of the flagship inference
   domain (24 h, 546 x 756 px, 63 patches) with the bundled generator and
   texture gate; checks the output and the kernel's launches, times one
   call after a warm-up, and profiles one more call;
6. training reference: two WGAN-GP steps in f32 at a small shape on the
   card against the same two steps on the CPU, each step from the same
   state and draws;
7. training path: ``WindDownscalingGAN`` at the flagship training shape
   (batch 2, 96 px, T=24, generator F=128, critic F=16, bf16) with the
   metric suite and the spatial KS on, ``train.loop.train`` for four steps
   after a warm-up step; checks metrics, parameter movement, both kernels'
   launches per step and the checkpoint, prints seconds per step and peak
   memory, and profiles one more step;
8. one JSON line with the kernels, then the result line.

Phase names given as arguments run only those phases (for bring-up); the
JSON lines are printed only by the full run.  It imports nothing of JAX or
of the ``windtpu`` package.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_OPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

# (B, T, H, W, F) of the generator's K1 on the downscale and training paths.
MAIN_SHAPE = (16, 24, 24, 24, 128)
TRAIN_SHAPE = (2, 24, 24, 24, 128)
GRAD_SHAPE = (2, 6, 24, 24, 128)
RAGGED_SHAPE = (3, 5, 7, 7, 40)
TOL = {"bfloat16": 2.0 ** -5, "float32": 1e-4}
# K1's bf16 gradient with hard_sigmoid: relative L2 and the share of entries
# beyond TOL x max |grad| (see convlstm_gradient_phase).
GRAD_KINK_L2, GRAD_KINK_SHARE = 2.0 ** -4, 1e-3
# K2 on the training path: (B, T, H, W, C) -> 96 fields of 96 x 96.
KS_SHAPE, KS_ARGS = (2, 24, 96, 96, 2), dict(patch_size=9, num_points=100)
KS_RAGGED, KS_RAGGED_ARGS = (1, 3, 37, 53, 2), dict(patch_size=5,
                                                    num_points=25)
KS_TOL = 1e-6
# The f32 flagship network on the card vs the CPU, output in m/s; and the
# f32 train steps on the card vs the CPU, relative to max(1, |value|).
REFERENCE_TOL = 2e-3
TRAIN_STEPS = 4

KERNELS = [{
    "name": "convlstm_seq",
    "route": "cuda",
    "source": "windtpu_torch/ops/csrc/convlstm.cu",
    "replaces": "windtpu/ops/pallas_convlstm.py:196",
}, {
    "name": "spatial_ks",
    "route": "cuda",
    "source": "windtpu_torch/ops/csrc/spatial_ks.cu",
    "replaces": "windtpu/ops/pallas_ks.py:97",
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
    from windtpu_torch.ops._build import build

    sources = {"convlstm_seq": "convlstm", "spatial_ks": "spatial_ks"}
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        futures = {name: pool.submit(build, source)
                   for name, source in sources.items()}
    for name, future in futures.items():
        info = future.result()
        print(f"{name}: {info.path.name} built={info.built} "
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


def convlstm_kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from windtpu_torch.ops.convlstm import convlstm_seq, convlstm_seq_plain

    cases = [(MAIN_SHAPE, torch.bfloat16, True),
             (MAIN_SHAPE, torch.float32, True),
             (TRAIN_SHAPE, torch.bfloat16, True),
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
    stats = {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    stats.update(convlstm_gradient_phase())
    return stats


def convlstm_gradient_phase() -> dict:
    """K1's gradients through the kernel-forward Function (whose backward
    replays ``convlstm_scan``) against autograd through the plain version,
    then the times of one forward and one forward + backward at the
    training path's shape."""
    import torch

    from windtpu_torch.ops.convlstm import convlstm_seq, convlstm_seq_plain

    b, t, h, w, f = GRAD_SHAPE
    cases = [(torch.bfloat16, True), (torch.bfloat16, False),
             (torch.float32, True), (torch.float32, False)]
    for i, (dtype, hard) in enumerate(cases):
        g = torch.from_numpy(np.random.default_rng(40 + i).standard_normal(
            (b, t, h, w, f), dtype=np.float32)).to("cuda", dtype)
        grads = []
        for fn in (convlstm_seq, convlstm_seq_plain):
            zx, rk = convlstm_inputs(GRAD_SHAPE, dtype, seed=50 + i)
            zx.requires_grad_()
            rk.requires_grad_()
            grads.append(torch.autograd.grad(fn(zx, rk, hard_sig=hard),
                                             (zx, rk), g))
        torch.cuda.synchronize()
        tol = TOL[str(dtype).split(".")[-1]]
        for name, got, want in zip(("zx.grad", "rk.grad"), *grads):
            got, want = got.float(), want.float()
            scale = max(1.0, want.abs().max().item())
            diff = (got - want).abs()
            err = diff.max().item()
            rel_l2 = (diff.norm() / want.norm()).item()
            beyond = (diff > tol * scale).float().mean().item()
            if dtype == torch.bfloat16 and hard:
                # The replay computes its gates in bf16, the plain version
                # in f32.  An element that rounds across a kink of
                # hard_sigmoid takes the other slope (0.2 or 0), which moves
                # single gradient entries by O(1): hold the whole tensor in
                # relative L2 and the share of entries beyond the tolerance.
                ok = rel_l2 <= GRAD_KINK_L2 and beyond <= GRAD_KINK_SHARE
            else:
                ok = err <= tol * scale
            ok = ok and bool(torch.isfinite(got).all().item())
            print(f"convlstm_seq {GRAD_SHAPE} {dtype} hard_sig={hard} "
                  f"{name}: max_abs_err {err:.3e} (tol {tol:.1e} x max "
                  f"|grad| {scale:.3e}), relative L2 {rel_l2:.3e}, share "
                  f"beyond tol {beyond:.2e} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"convlstm_seq's {name} disagrees with autograd "
                     f"through its plain version in {dtype}, "
                     f"hard_sig={hard}")

    zx, rk = convlstm_inputs(TRAIN_SHAPE, torch.bfloat16, seed=0)
    g = torch.ones(TRAIN_SHAPE, device="cuda", dtype=torch.bfloat16)
    forward_ms = cuda_ms(lambda: convlstm_seq(zx, rk), iters=20)
    zx.requires_grad_()
    rk.requires_grad_()
    both_ms = cuda_ms(lambda: torch.autograd.grad(
        convlstm_seq(zx, rk), (zx, rk), g), iters=10)
    bound_ms, bound_by, _, _ = convlstm_bound(TRAIN_SHAPE, 2)
    print(f"convlstm_seq {TRAIN_SHAPE} bf16 (training path): forward "
          f"{forward_ms:.4f} ms, forward + replayed backward {both_ms:.4f} "
          f"ms (backward {both_ms - forward_ms:.4f} ms), forward bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"train_ms": forward_ms,
            "train_backward_ms": both_ms - forward_ms,
            "train_bound_ms": bound_ms}


def ks_inputs(shape, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    real = 8.0 * rng.standard_normal(shape, dtype=np.float32)
    fake = real + 4.0 * rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(real).cuda(), torch.from_numpy(fake).cuda()


def ks_bound(shape, patch_size: int, num_points: int):
    """Least time of one call: each f32 field read once and each KS image
    written once, vs the running-sum form of the arithmetic on the CUDA
    cores: per field pair and threshold 2*H*W comparisons, H*W differences,
    2*OH*W vertical and 2*OH*OW horizontal adds, 2*OH*OW for |.| and max."""
    b, t, h, w, c = shape
    n, oh, ow = b * t * c, h - patch_size + 1, w - patch_size + 1
    ops = float(n) * num_points * (3 * h * w + 2 * oh * w + 4 * oh * ow)
    nbytes = 4.0 * n * (2 * h * w + oh * ow)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), ops, nbytes


def ks_kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from windtpu_torch.metrics.metrics import (
        ks_fields,
        ks_thresholds,
        spatially_convolved_ks_stat,
    )
    from windtpu_torch.ops.ks import spatial_ks

    main_err = None
    cases = [("path", KS_SHAPE, KS_ARGS, False),
             ("ragged", KS_RAGGED, KS_RAGGED_ARGS, False),
             ("path with NaNs", KS_SHAPE, KS_ARGS, True),
             ("one threshold, patch = H", (1, 2, 12, 20, 1),
              dict(patch_size=12, num_points=1), False)]
    for i, (name, shape, kw, nans) in enumerate(cases):
        real, fake = ks_inputs(shape, seed=60 + i)
        if nans:
            real[0, 0, 3:5, 7, 0] = float("nan")
            fake[1, 2, 50, 10:40, 1] = float("nan")
        got = spatial_ks(real, fake, **kw)
        want = spatially_convolved_ks_stat(real, fake, **kw)
        same = spatial_ks(real, real.clone(), **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        zero = bool((same == 0).all().item())
        ok = (bool(torch.isfinite(got).all().item()) and err <= KS_TOL
              and zero and got.shape == want.shape)
        print(f"spatial_ks {name} {shape} {kw}: max_abs_err {err:.3e} (tol "
              f"{KS_TOL:.0e}), mean {got.mean().item():.4f}, identical "
              f"fields exactly 0: {zero} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"spatial_ks disagrees with its plain version ({name})")
        if i == 0:
            main_err = err

    real, fake = ks_inputs(KS_SHAPE, seed=60)
    ms = cuda_ms(lambda: spatial_ks(real, fake, **KS_ARGS), iters=20)
    plain_ms = cuda_ms(
        lambda: spatially_convolved_ks_stat(real, fake, **KS_ARGS),
        iters=3, warmup=1)
    # No single PyTorch call computes this function.  The nearest
    # yardstick: F.avg_pool2d of the two indicator images, in a loop over
    # the thresholds.
    fr, ff = ks_fields(real)[:, None], ks_fields(fake)[:, None]
    patch = KS_ARGS["patch_size"]
    points = ks_thresholds(KS_ARGS["num_points"], -30.0, 30.0, "cuda")

    def yardstick():
        best = torch.zeros((), device="cuda")
        for p in points:
            diff = (F.avg_pool2d((fr <= p).float(), patch, stride=1)
                    - F.avg_pool2d((ff <= p).float(), patch, stride=1))
            best = torch.maximum(best, diff.abs())
        return best.mean(dim=0)

    yardstick_ms = cuda_ms(yardstick, iters=3, warmup=1)
    bound_ms, bound_by, ops, nbytes = ks_bound(KS_SHAPE, **KS_ARGS)
    print(f"spatial_ks {KS_SHAPE} {KS_ARGS} (96 field pairs, one launch): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, yardstick "
          f"(avg_pool2d per threshold, not one call) {yardstick_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.3f} G "
          f"operations at {PEAK_F32_OPS / 1e12:.0f}e12/s, "
          f"{nbytes / 1e6:.1f} MB); kernel at {ops / ms / 1e9:.2f} "
          f"T operations/s")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "yardstick_ms": yardstick_ms}


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


def downscale_path_phase() -> dict:
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

    profile_device(lambda: api.downscale(era5, raster, network=network))
    profile_host(lambda: api.downscale(era5, raster, network=network))
    return counts


def train_batches(cfg, n: int, seed: int):
    """``n`` (low_res, high_res) batches at ``cfg``'s training shape, from
    ``seed``: unit-normal inputs, wind-like targets of a few m/s."""
    rng = np.random.default_rng(seed)
    m = cfg.model
    shape = (cfg.train.batch_size, m.sequence_length, m.image_size,
             m.image_size)
    return [(rng.standard_normal(shape + (m.in_channels,), dtype=np.float32),
             4.0 * rng.standard_normal(shape + (m.out_channels,),
                                       dtype=np.float32))
            for _ in range(n)]


def training_reference_phase() -> None:
    import torch

    from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
    from windtpu_torch.train.state import create_train_state
    from windtpu_torch.train.wgan_gp import draw_step_noise, make_train_step
    from windtpu_torch.weights import export_train_state, load_train_state

    cfg = GANConfig(
        model=ModelConfig(image_size=24, sequence_length=4,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=2, compute_spatial_ks=True))
    batches = train_batches(cfg, 2, seed=2)
    step = make_train_step(cfg)
    devices = ("cuda", "cpu")
    states = {dev: create_train_state(cfg, seed=3, device=dev)
              for dev in devices}
    rngs = {dev: torch.Generator().manual_seed(4) for dev in devices}
    seconds = dict.fromkeys(devices, 0.0)
    worst = worst_param = 0.0
    for i, (low_res, high_res) in enumerate(batches):
        if i > 0:
            # Each step starts from the CPU's state on both devices.  The
            # schedule is stiff at the start of training (gradient-penalty
            # weight 100, three critic updates per step): every critic
            # update multiplies a rounding difference several times, so
            # two free-running copies drift apart by more than any fixed
            # tolerance that would still catch a fault.
            load_train_state(states["cuda"],
                             export_train_state(states["cpu"]))
        metrics = {}
        for dev in devices:
            draws = draw_step_noise(cfg, low_res.shape, high_res.shape[-1],
                                    rngs[dev], dev)
            t0 = time.perf_counter()
            _, out = step(states[dev], low_res, high_res, draws=draws)
            metrics[dev] = {k: float(v) for k, v in out.items()}
            seconds[dev] += time.perf_counter() - t0
        for key, value in metrics["cpu"].items():
            got = metrics["cuda"][key]
            err = abs(got - value) / max(1.0, abs(value))
            worst = max(worst, err)
            if not np.isfinite(got) or err > REFERENCE_TOL:
                fail(f"train step {i + 1} metric {key}: card {got!r} vs "
                     f"CPU {value!r}")
        got_state = export_train_state(states["cuda"])
        want_state = export_train_state(states["cpu"])
        sample = [k for k in sorted(want_state) if k.split("/")[0] in (
            "g_params", "d_params", "g_batch_stats", "g_spectral",
            "d_spectral")][::5]
        worst_param = max(worst_param, max(
            float(np.abs(got_state[k] - want_state[k]).max())
            for k in sample))
    print(f"training reference: f32, batch 2, 24 px, T=4, F=128/16, two "
          f"steps (card {seconds['cuda']:.2f} s, CPU {seconds['cpu']:.2f} "
          f"s), card vs CPU: metrics within {worst:.3e} (relative to "
          f"max(1, |value|)), {len(sample)} sampled tensors of the updated "
          f"state within {worst_param:.3e} (tol {REFERENCE_TOL:.0e})")
    if worst_param > REFERENCE_TOL:
        fail("the card's f32 train steps disagree with the CPU's")


def training_path_phase() -> dict:
    import torch

    from windtpu_torch import api
    from windtpu_torch.network import WindDownscalingGAN
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.train import checkpoint as ckpt
    from windtpu_torch.train import loop
    from windtpu_torch.weights import export_flax_variables

    # The flagship training shape: batch 2, 96 px, T=24, generator F=128,
    # critic F=16, bf16 compute, metric suite and spatial KS in the step.
    base = api.flagship_config()
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = dataclasses.replace(
        base, train=dataclasses.replace(
            base.train, batch_size=2, compute_metrics=True,
            compute_spatial_ks=True))
    net = WindDownscalingGAN(cfg).load_weights(api.BUNDLED_GENERATOR)
    batches = train_batches(cfg, 1 + TRAIN_STEPS + 2, seed=0)
    seq = cfg.model.sequence_length

    loop.train(cfg, batches[:1], 1, state=net.state,
               log_fn=lambda step, metrics: None)       # warm-up
    torch.cuda.synchronize()
    before = {name: export_flax_variables(getattr(net, name))
              for name in ("generator", "discriminator")}

    counts = {"convlstm_seq": 0, "spatial_ks": 0}
    convlstm_seq.launches = spatial_ks.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = []

    def log_fn(step, metrics):
        # loop.train converts the metrics to floats before this call, so
        # the step's device work has finished here.
        log.append((step, time.perf_counter(), convlstm_seq.launches,
                    spatial_ks.launches, metrics))

    timed_cfg = dataclasses.replace(cfg, checkpoint_dir=str(ckpt_dir))
    t0 = time.perf_counter()
    loop.train(timed_cfg, batches[1:1 + TRAIN_STEPS], TRAIN_STEPS,
               state=net.state, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    counts["convlstm_seq"] = convlstm_seq.launches
    counts["spatial_ks"] = spatial_ks.launches
    peak = torch.cuda.max_memory_allocated()

    if [entry[0] for entry in log] != list(range(2, 2 + TRAIN_STEPS)):
        fail(f"logged steps {[entry[0] for entry in log]}")
    last_t, last_k1, last_k2 = t0, 0, 0
    for step, t, k1, k2, metrics in log:
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            fail(f"step {step}: metrics {bad} are not finite")
        if not 0.0 <= metrics["g_spatial_ks"] <= 1.0:
            fail(f"step {step}: g_spatial_ks {metrics['g_spatial_ks']}")
        if k1 - last_k1 != 5 * seq or k2 - last_k2 != 1:
            fail(f"step {step}: convlstm_seq launched {k1 - last_k1} times "
                 f"(expected 5 generator forwards x {seq} steps) and "
                 f"spatial_ks {k2 - last_k2} (expected 1)")
        shown = {k: round(metrics[k], 4) for k in (
            "g_loss", "d_loss", "d_gradient_pen", "g_ws_rmse",
            "g_spatial_ks")}
        print(f"train step {step}: {t - last_t:.3f} s, convlstm_seq "
              f"launches {k1 - last_k1}, spatial_ks launches "
              f"{k2 - last_k2}, {shown}")
        last_t, last_k1, last_k2 = t, k1, k2
    seconds_per_step = (log[-1][1] - t0) / TRAIN_STEPS
    for name, old in before.items():
        new = export_flax_variables(getattr(net, name))
        still = sorted(k for k in old if k.startswith("params/")
                       and np.array_equal(old[k], new[k]))
        # Two of the critic's biases only shift every score by one constant
        # (the dense bias, and the last LayerNorm's bias, which the dense
        # layer sums): that cancels in E[real] - E[fake] and does not reach
        # the image gradient, so their gradient is exactly zero.
        critic = net.discriminator
        last_norm = (critic.pyramid3 or critic.pyramid2
                     or critic.pyramid1)[-1][1]
        constants = {"params/score_dense/dense/bias",
                     f"params/{last_norm}/ln/bias"}
        if set(still) - (constants if name == "discriminator" else set()):
            fail(f"{name}: parameters {still[:5]} did not move")
    latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest is None or not latest.endswith(
            f"step_{1 + TRAIN_STEPS:08d}.pt"):
        fail(f"no checkpoint of step {1 + TRAIN_STEPS} under {ckpt_dir}: "
             f"{latest}")
    other = WindDownscalingGAN(cfg, seed=1).load_weights(ckpt_dir)
    for name in ("generator", "discriminator"):
        a = getattr(net, name).state_dict()
        b = getattr(other, name).state_dict()
        if other.state.step != net.state.step or not all(
                torch.equal(a[k], b[k]) for k in a):
            fail(f"the reloaded checkpoint's {name} differs")
    print(f"training path: batch 2 x T=24 x 96 px, F=128/16, bf16, "
          f"{TRAIN_STEPS} steps: {seconds_per_step:.3f} s per step, peak "
          f"memory allocated {peak / 2**20:.0f} MiB, checkpoint "
          f"{Path(latest).name} ({Path(latest).stat().st_size / 2**20:.1f} "
          f"MiB) written and reloaded")

    rng = torch.Generator(device="cuda").manual_seed(1)
    extra = batches[1 + TRAIN_STEPS:]
    profile_device(lambda: net.train_step(*extra[0], rng))
    profile_host(lambda: net.train_step(*extra[1], rng))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
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


def profile_device(fn) -> None:
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


PHASES = {
    "build": build_all,
    "kernel convlstm_seq": convlstm_kernel_phase,
    "kernel spatial_ks": ks_kernel_phase,
    "reference": reference_phase,
    "downscale path": downscale_path_phase,
    "training reference": training_reference_phase,
    "training path": training_path_phase,
}


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

    chosen = sys.argv[1:]
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; known: "
              f"{list(PHASES)}", file=sys.stderr)
        return 2
    phase("device")
    smi = device_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    results = {}
    for name, fn in PHASES.items():
        if not chosen or name in chosen:
            phase(name)
            results[name] = fn()
    if chosen:
        print(f"ran only {chosen}: no result line")
        return 0

    stats = {"convlstm_seq": results["kernel convlstm_seq"],
             "spatial_ks": results["kernel spatial_ks"]}
    paths = {"downscale": results["downscale path"],
             "train": results["training path"]}
    kernels = []
    for k in KERNELS:
        by_path = {path: counts.get(k["name"], 0)
                   for path, counts in paths.items()}
        if by_path["train"] == 0:
            fail(f"{k['name']} was not launched on the training path")
        kernels.append({**k, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **stats[k["name"]]})
    if paths["downscale"]["convlstm_seq"] == 0:
        fail("convlstm_seq was not launched on the downscale path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
