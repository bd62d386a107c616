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
   the kernel's bound.  K1 (ConvLSTM): forward in bf16 (tensor cores) and
   f32 (CUDA cores, bitwise repeatable), the tile (and the f32 route's
   split over the taps) chosen per shape, the times at the shapes of the
   downscale, training and ensemble paths (bf16) and of the downscale,
   train_main, its ranks and the prepare path (f32) beside cuDNN's convs,
   and the gradients through its autograd Function.
   K2 (spatial KS): also on identical fields, with NaNs and with values on
   the thresholds.  The critic's LayerNorm (no TPU kernel: forward,
   backward and double backward) at every map of the flagship critic and
   of train_main's, beside ATen's layer norm, and its host time per call;
4. reference: the flagship network in f32 with the bundled weights on a
   small domain, on the card (kernels) against the CPU (plain versions);
5. downscale path: ``windtpu_torch.api.downscale`` of the flagship inference
   domain (24 h, 546 x 756 px, 63 patches) with the bundled generator and
   texture gate; checks the output, the kernel's launches and that the
   gate's energies were predicted once, on the card; times one
   call after a warm-up;
6. training reference: two WGAN-GP steps in f32 at a small shape on the
   card against the same two steps on the CPU, each step from the same
   state and draws, without and with the reconstruction loss;
7. training path: ``WindDownscalingGAN`` at the flagship training shape
   (batch 2, 96 px, T=24, generator F=128, critic F=16, bf16) with the
   metric suite and the spatial KS on, ``train.loop.train`` for four steps
   after a warm-up step; checks metrics, parameter movement, both kernels'
   launches per step (K1's through its wrapper: the warm-up step captured
   the critic updates as a CUDA graph, whose replays launch their K1
   without it) and the checkpoint, prints seconds per step and peak
   memory;
8. streaming path: ``api.downscale`` of the flagship domain through the
   host-streaming engine, and ensembles of 4 members through both engines;
   streamed against monolithic (f32 within the JAX package's tolerance,
   bf16 within a stated limit), bf16 against f32 transfers, each member
   against a one-member run with its seed; seconds, patches/s and kernel
   launches of each run, the transfers' device times, streamed peak memory
   at two domain sizes, and the monolithic engine's peak memory (after the
   gate's energy prediction on the card, which must not raise it) at three
   domain sizes, which sets ``api._STREAMING_DEFAULT_BYTES``, and with 4
   members at that threshold;
9. train entry: ``cli.train_main`` with ``--synthetic`` at its default shape
   (batch 16, 32 px, T=6, F=128) and the spatial KS on; seconds per step,
   peak memory, both kernels' launches and the critic graph's one capture
   and its replays;
10. prepare path: ``cli.prepare_main topo`` of a DEM over the COSMO-1
    window at 3 arc-seconds (about 22 Mpx, with NaN holes) on the card
    under PyTorch's default TF32 settings and on the CPU, the eight
    descriptors held against each other; ``prepare daily`` of two
    fabricated ERA5 + COSMO-1 days; ``cli.train_main`` on them with
    ``--reconstruction-coefficient 1.0`` at 96 px, T=24, batch 2 (where the
    bundled encoder loads, which it checks), seconds per step, peak memory
    and K1's launches;
11. multi-GPU path (NCCL refuses two ranks on one card, so two ranks
    share card 0 under gloo: these runs test correctness, not speed): (i) ``cli.train_main`` with
    ``--coordinator-address/--num-processes 1/--process-id 0`` over NCCL
    at the train entry's shape, 2 steps, against a plain single-process
    ``train_main``; (ii) the same at 2 gloo ranks on ``cuda:0``: ranks
    with identical state, within a stated limit of the single process,
    K1 and K2 launched in each rank; (iii) 2 gloo ranks on ``cuda:0``
    running the flagship ``api.downscale`` tile-parallel (against the
    single-device run with the same seed, within the streaming phase's
    bf16 limit) and a 2-member ensemble over an ``ensemble`` axis of 2
    (against the one-member runs of its seeds, exactly).  Each rank's
    seconds, peak memory, launches and all-reduce bytes;
12. multi-card path, on a machine with 2 or more cards (the full run on
    one card prints a line saying why it did not run; naming the phase
    there fails): one rank per card over NCCL, W = 4 ranks (2 on 2 or 3
    cards).  ``cli.train_main`` at the train entry's shape at 1, 2 and W
    ranks, 2 and 6 steps each (seconds per step from the difference of
    the walls, all-reduce bytes, calls and CUDA-event time per step, peak
    memory per rank), the first W-rank run started through torchrun's
    variables and followed by one ``make_sharded_train_step`` step: ranks
    bitwise equal, the 2-step runs within the multi-GPU limit of the
    single process on card 0, both planted faults at W ranks beyond it,
    K1 and K2 in every rank.  The flagship ``api.downscale`` at W ranks:
    tile-parallel (within the streaming bf16 limits of one card), 2
    members (data 2 x ensemble 2 at W = 4) and 4 members (ensemble W),
    each member exactly its one-member run; each rank's wall beside one
    card's;
13. A13 path: one train step at the training path's shape from one saved
    state and one set of draws under each ``TrainConfig.remat`` mode
    (False twice, True, "save_scans" and "d_only" with ``remat_gp``,
    "d_only" without), in bf16 and in f32 (there with cuDNN's
    deterministic algorithms): seconds, peak memory (and of each part of
    the step), both kernels' launches and the metrics and forward-written
    state against remat=False; two f32
    steps under "save_scans" on the card against the CPU; the texture
    gate's device half (``predict_log_energy`` on the flagship inference
    field against the host twin, with both times, and ``apply_gate`` on
    the card against the CPU and the split path); ``profile_region``
    around a flagship downscale, whose trace must hold K1;
14. one JSON line with the kernels and their launches by path, counted
    where their wrappers launch them (a replayed graph's are not among
    them), then the result line.

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

from portbench.costs import PEAK_BYTES, PEAK_FLOPS
from portbench.costs.kernels import k1_bytes, k1_flops, k2_bytes, k2_ops

ROOT = Path(__file__).resolve().parent

# (B, T, H, W, F) of the generator's K1 on the downscale and training paths.
MAIN_SHAPE = (16, 24, 24, 24, 128)
TRAIN_SHAPE = (2, 24, 24, 24, 128)
# ... on the 4-member ensemble path (one batched forward of 4 x 16 patches)
# and in train_main (batch 16, T=6, 32 px; its ModelConfig computes in f32,
# so K1 takes its f32 route there).
ENSEMBLE_SHAPE = (64, 24, 24, 24, 128)
TRAIN_MAIN_SHAPE = (16, 6, 8, 8, 128)
# ... and in train_main on the prepared days (batch 2, 96 px, T=24, f32).
PREPARE_SHAPE = (2, 24, 24, 24, 128)
# ... and in each of the two ranks of train_main on the multi-GPU path
# (8 rows of the batch of 16 each, f32).  The tile-parallel and
# ensemble-parallel downscale ranks run whole groups of 16: MAIN_SHAPE.
TRAIN_RANK_SHAPE = (8, 6, 8, 8, 128)
# ... and in each of the four ranks of train_main on the multi-card path
# (4 rows each).
TRAIN_RANK4_SHAPE = (4, 6, 8, 8, 128)
GRAD_SHAPE = (2, 6, 24, 24, 128)
RAGGED_SHAPE = (3, 5, 7, 7, 40)
NARROW_SHAPE = (2, 3, 5, 9, 12)   # F not a multiple of 8
NARROW_F32_SHAPE = (2, 3, 5, 9, 6)   # F not a multiple of 4
TOL = {"bfloat16": 2.0 ** -5, "float32": 1e-4}
# K1's bf16 gradient with hard_sigmoid: relative L2 and the share of entries
# beyond TOL x max |grad| (see convlstm_gradient_phase).
GRAD_KINK_L2, GRAD_KINK_SHARE = 2.0 ** -4, 1e-3
# K2 on the training path: (B, T, H, W, C) -> 96 fields of 96 x 96.
KS_SHAPE, KS_ARGS = (2, 24, 96, 96, 2), dict(patch_size=9, num_points=100)
KS_RAGGED, KS_RAGGED_ARGS = (1, 3, 37, 53, 2), dict(patch_size=5,
                                                    num_points=25)
# ... and in train_main's step: 16 x 6 fields of 32 x 32, patch 32 // 10.
KS_TRAIN_MAIN, KS_TRAIN_MAIN_ARGS = (16, 6, 32, 32, 2), dict(patch_size=3,
                                                            num_points=100)
# ... and in each of its two ranks on the multi-GPU path.
KS_TRAIN_RANK = (8, 6, 32, 32, 2)
KS_TRAIN_RANK4 = (4, 6, 32, 32, 2)
KS_TOL = 1e-6
# The critic's LayerNorm maps: the flagship train step's penalty call
# (batch 8, T=24, bf16; 96 px of 16 channels, then the pyramid's 64, 128
# and 256) and train_main's (batch 16, T=6, f32; 32 px of 16, then 64 and
# 128).  The first of each is timed beside the plain stages and ATen's.
LN_MAPS = {"flagship": ([(8, 24, 96, 96, 16), (8, 24, 31, 31, 64),
                         (8, 24, 9, 9, 128), (8, 24, 2, 2, 256)],
                        "bfloat16"),
           "train_main": ([(16, 6, 32, 32, 16), (16, 6, 10, 10, 64),
                           (16, 6, 2, 2, 128)], "float32")}
# A kernel's output against its plain stage's on the same card tensors:
# both round the same f32 arithmetic, summed in another order, once to the
# output's dtype, so within 2^-7 of the value for bf16 and 2e-5 for f32
# (the f32 mean and rstd too), plus 2e-5 of the output's largest value for
# entries left small by cancellation (tests/test_torch_layer_norm.py).
LN_RTOL = {"bfloat16": 2 ** -7, "float32": 2e-5}
LN_ATOL = 2e-5
# The f32 flagship network on the card vs the CPU, output in m/s; and the
# f32 train steps on the card vs the CPU, relative to max(1, |value|).
REFERENCE_TOL = 2e-3
TRAIN_STEPS = 4
# Streaming against the monolithic engine in f32: the JAX package's
# tolerance (fp64 host statistics against f32 device ones).
STREAM_ATOL, STREAM_RTOL = 2e-3, 1e-3
# The same in bf16 through api.downscale: the statistics' last bits move a
# few inputs across a bf16 rounding boundary, which moves outputs by a bf16
# step.  Max |difference| at most 2^-7 x the channel's largest |value|,
# the bound of a bf16 step at that scale (0.25 m/s between 32 and 64 m/s);
# not the step itself, since the overlap mean and the gate's gain rescale
# the network's bf16 output (the H100 measured 0.0633 m/s on v10 at scale
# 14.7, one step being 0.0625).  Mean |difference| in m/s above the
# largest measured (9.1e-4) by a tenth.
STREAM_BF16_REL, STREAM_BF16_MEAN_TOL = 2.0 ** -7, 1e-3
# bf16 against f32 transfers on the streamed path, and member m of an
# ensemble against the one-member run with its seed (one batched forward of
# 64 patches against four of 16): exactly equal on the H100 with the bf16
# network, which rounds its input to bf16 as the transfer does and whose
# output is bf16, and whose per-patch arithmetic does not depend on the
# batch.
TRANSFER_BF16_TOL = MEMBER_TOL = 0.0
MEMBERS = 4
# The monolithic engine's peak memory is measured at these (H, W, members)
# domains of 24 h to check the threshold against the card's memory: one
# member at 0.5, 3 and 12 GiB of _engine_hbm_bytes (the last at
# api._STREAMING_DEFAULT_BYTES), and 4 members at the largest square domain
# the default keeps monolithic (11.995 GiB; 64-patch forwards).
THRESHOLD_DOMAINS = [(836, 836, 1), (2048, 2048, 1), (4096, 4096, 1),
                     (2590, 2590, MEMBERS)]
# The predicted peak at the default threshold must stay under this share of
# the card's memory.
THRESHOLD_SHARE = 0.5
# train_main's default shape and the steps of its two timed runs.
TRAIN_MAIN_STEPS = (2, 6)
TRAIN_ENTRY_ARGV = ["--inputs", "unused", "--outputs", "unused",
                    "--synthetic", "--spatial-ks"]
# The reconstruction loss's weight in the training reference and on the
# prepare path (the JAX CLI's --reconstruction-coefficient 1.0).
RECO_COEFFICIENT = 1.0
# The prepare path: a DEM over the COSMO-1 window at 3 arc-seconds with
# NaN holes, two days, and train_main's two timed runs on them.  The card's
# descriptors against the CPU's: metres (elevation, TPI, ridge norm) and
# the derivatives.
DEM_STEP_DEG = 1.0 / 1200.0
DEM_HOLES = 40
PREPARE_DAYS = ("2020-01-01", "2020-01-02")
PREPARE_TRAIN_STEPS = (2, 4)
TOPO_M_TOL, TOPO_DERIVATIVE_TOL = 1e-3, 1e-5
# The multi-GPU path: train_main at its default shape with the spatial KS,
# 2 steps per run.  Ranks hold identical states (all-reduced gradients and
# BatchNorm statistics, the same optimizer arithmetic).  A run over ranks
# against the single process: every tensor of the state (parameters,
# BatchNorm statistics, spectral vectors, Adam's moments, counts) is held
# against its movement in the single process's run, part by part
# (state_error): ||got - want|| / ||want - start||.  An absolute
# limit cannot tell a wrong update from a right one: Adam moves each
# parameter by about the learning rate (1e-4) per step whatever its
# gradient, so two steps move it by about 2e-4.  The limit sits above the
# card's own run-to-run spread (two identical single-process runs; cuDNN's
# backward kernels sum in no fixed order, and the critic's kinks pass that
# on to its gradients), and each planted fault must exceed it.
MULTI_STEPS = 2
MULTI_TRAIN_TOL = 0.05
# Faults planted in both ranks of a gloo run (see plant_fault), which the
# comparison with the single process must catch.
MULTI_FAULTS = ("sum where the mean belongs", "local BatchNorm statistics")
MULTI_TIMEOUT = 600
# The multi-card path: one rank per card over NCCL, at W = the card count
# up to MULTI_CARDS (W = 2 on 2 or 3 cards), the same global batch at 1, 2
# and W ranks; runs of TRAIN_MAIN_STEPS steps each give seconds per step as
# the difference of their walls.  The flagship downscale at W ranks: one
# member tile-parallel (data W), 2 members (data W/2 x ensemble 2) and
# MEMBERS members (ensemble W, MEMBERS / W each).
MULTI_CARDS = 4
# The A13 path.  One train step at the training path's shape from one
# saved state and one set of draws under each remat mode, in this order:
# (name, TrainConfig.remat, remat_gp).  The state the forwards write
# (spectral vectors, BatchNorm running statistics) within REMAT_STATE_TOL
# relative of the first run's, and each metric within REMAT_METRIC_TOL
# relative.  Measured on the H100, two identical remat=False runs already
# differ: in bf16 by bf16 steps of the critic's mean score (up to 1.1e-2
# relative on d_fake), in f32 with cuDNN's default algorithms by 5.4e-7 in
# the critic's spectral vectors and 2.5e-4 in d_fake (its backward sums in
# no fixed order, and Adam and the critic's kinks pass that on).  So the
# bf16 pass (cuDNN's defaults, as a user runs it) holds the state and
# prints the metrics beside that spread, and the f32 pass, with cuDNN's
# deterministic algorithms, holds both.
REMAT_RUNS = [("False", False, False), ("False again", False, False),
              ("True+remat_gp", True, True),
              ("save_scans+remat_gp", "save_scans", True),
              ("d_only+remat_gp", "d_only", True), ("d_only", "d_only", False)]
REMAT_METRIC_TOL, REMAT_STATE_TOL = 1e-3, 1e-6
# The texture gate's device half against its host twin (complex64 against
# complex128 FFTs) and the CPU, in log energy and m/s.
GATE_TOL = 1e-4

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
}, {
    "name": "layer_norm",
    "route": "cuda",
    "source": "windtpu_torch/ops/csrc/layer_norm.cu",
    "replaces": None,
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

    sources = {"convlstm_seq": "convlstm", "spatial_ks": "spatial_ks",
               "layer_norm": "layer_norm"}
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


def graph_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured as
    one CUDA graph after a warm-up, the replay timed with CUDA events, so
    that the host's time per call is not counted."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def convlstm_bound(shape, dtype: str):
    """Least time of one sequence: its operations (``k1_flops``) at the
    peak for their type (bf16 on the tensor cores, f32 outside them) vs
    its bytes (``k1_bytes``) at the memory bandwidth."""
    flops, nbytes = k1_flops(*shape), k1_bytes(*shape, dtype)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def convlstm_kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from windtpu_torch.ops._build import build
    from windtpu_torch.ops.convlstm import (
        F32_TILES,
        TILES,
        bf16_grid,
        bf16_l2_bytes,
        choose_tile,
        choose_tile_f32,
        convlstm_seq,
        convlstm_seq_plain,
        f32_blocks,
    )
    from windtpu_torch.ops.convlstm_variants import hgmma_counts

    cases = [(MAIN_SHAPE, torch.bfloat16, True),
             (MAIN_SHAPE, torch.float32, True),
             (TRAIN_SHAPE, torch.bfloat16, True),
             (ENSEMBLE_SHAPE, torch.bfloat16, True),
             (TRAIN_MAIN_SHAPE, torch.float32, True),
             (PREPARE_SHAPE, torch.float32, True),
             (RAGGED_SHAPE, torch.bfloat16, True),
             (RAGGED_SHAPE, torch.float32, False),
             (NARROW_SHAPE, torch.bfloat16, True),
             (TRAIN_RANK_SHAPE, torch.float32, True),
             (NARROW_F32_SHAPE, torch.float32, True),
             (TRAIN_RANK4_SHAPE, torch.float32, True)]
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
        # No atomics: the f32 route sums a cluster's partials in rank
        # order, the bf16 route runs its K loop in one order.  Two launches
        # on the same inputs agree in every bit.
        again = convlstm_seq(zx, rk, hard_sig=hard)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            fail(f"convlstm_seq is not bitwise repeatable at {shape} "
                 f"{dtype}")
        if i == 0:
            main_err = err

    # The bf16 kernel is wgmma: its SASS holds HGMMA instructions.
    hgmma = hgmma_counts(build("convlstm").path)
    print(f"convlstm_seq bf16 kernels, HGMMA instructions in the SASS "
          f"(CW, BJ, F % 8 == 0): {hgmma}")
    if not hgmma or min(hgmma.values()) == 0:
        fail("the bf16 kernel has no HGMMA instruction (or cuobjdump is "
             "missing)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16_tiles = {}
    for shape in (MAIN_SHAPE, TRAIN_SHAPE, ENSEMBLE_SHAPE, TRAIN_MAIN_SHAPE,
                  RAGGED_SHAPE, NARROW_SHAPE):
        b, t, h, w, f = shape
        code = choose_tile(b * h * w, f, sms)
        bm, bj, cluster = TILES[code]
        tiles, blocks = bf16_grid(b * h * w, f, code, sms)
        bf16_tiles[shape] = (bm, bj, cluster, tiles, blocks)
        l2 = bf16_l2_bytes(b * h * w, f, w, bm, bj, cluster)
        print(f"convlstm_seq {shape} bf16 tile: BM {bm} x BJ {bj}, clusters "
              f"of {cluster}; {tiles} tiles per step over {blocks} resident "
              f"blocks ({tiles / blocks:.2f} waves) on {sms} SMs; "
              f"{l2 / 1e6:.1f} MB from L2 per step (slab and halo windows)")
    for shape in (MAIN_SHAPE, TRAIN_MAIN_SHAPE, TRAIN_RANK_SHAPE,
                  PREPARE_SHAPE, RAGGED_SHAPE, NARROW_F32_SHAPE,
                  TRAIN_RANK4_SHAPE):
        b, t, h, w, f = shape
        code = choose_tile_f32(b * h * w, f, sms)
        bm, bj, split = F32_TILES[code]
        blocks = f32_blocks(b * h * w, f, code)
        print(f"convlstm_seq {shape} f32 tile: BM {bm} x BJ {bj}, split "
              f"{split} ({blocks} CTAs per step on {sms} SMs)")
        if shape in (TRAIN_MAIN_SHAPE, TRAIN_RANK_SHAPE, PREPARE_SHAPE) and (
                blocks < sms):
            fail(f"the f32 route leaves SMs idle at {shape}: {blocks} CTAs")

    def library_convs(shape, rk, dtype):
        # Library yardstick, conv part only: the T-1 recurrent 3x3 convs as
        # cuDNN calls on channels-last tensors of the kernel's dtype (no
        # single PyTorch call computes the whole recurrence).
        b, t, h, w, f = shape
        hx = torch.randn(b, f, h, w, device="cuda", dtype=dtype
                         ).contiguous(memory_format=torch.channels_last)
        wk = rk.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            for _ in range(t - 1):
                F.conv2d(hx, wk, padding=1)
        return library

    # One card, one call: the kernel, cuDNN and the kernel again at each
    # path's shape and type, and the plain version at the main shape.
    # (python3 -m windtpu_torch.ops.convlstm_variants times each f32 tile.)
    stats = {}
    for shape, dtype, key in ((MAIN_SHAPE, torch.bfloat16, None),
                              (TRAIN_SHAPE, torch.bfloat16, "train"),
                              (ENSEMBLE_SHAPE, torch.bfloat16, "ensemble"),
                              (MAIN_SHAPE, torch.float32, "f32"),
                              (TRAIN_MAIN_SHAPE, torch.float32, "train_main"),
                              (TRAIN_RANK_SHAPE, torch.float32, "train_rank"),
                              (TRAIN_RANK4_SHAPE, torch.float32,
                               "train_rank4"),
                              (PREPARE_SHAPE, torch.float32, "prepare")):
        zx, rk = convlstm_inputs(shape, dtype, seed=0)
        library = library_convs(shape, rk, dtype)
        bound_ms, bound_by, flops, nbytes = convlstm_bound(
            shape, str(dtype).split(".")[-1])
        ms = cuda_ms(lambda: convlstm_seq(zx, rk), iters=20)
        library_ms = cuda_ms(library, iters=20)
        ms_again = cuda_ms(lambda: convlstm_seq(zx, rk), iters=20)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        line = (f"convlstm_seq {shape} {name}, one sequence ({shape[1]} "
                f"launches): kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s; again {ms_again:.4f} ms), library (cuDNN conv "
                f"part only) {library_ms:.4f} ms "
                f"({flops / library_ms / 1e9:.1f} TFLOP/s), kernel / library "
                f"{ms / library_ms:.3f}, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; the kernel "
                f"at {bound_ms / ms:.1%} of it)")
        if dtype == torch.bfloat16:
            bm, bj, cluster, tiles, blocks = bf16_tiles[shape]
            line += (f"; tile {bm} x {bj}, {tiles} tiles over {blocks} "
                     f"blocks per step ({tiles / blocks:.2f} waves), clusters "
                     f"of {cluster}")
        if key is None:
            plain_ms = cuda_ms(lambda: convlstm_seq_plain(zx, rk), iters=5,
                               warmup=1)
            line += f"; plain {plain_ms:.4f} ms"
            stats.update({"max_abs_err": main_err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": library_ms})
        else:
            stats.update({f"{key}_library_ms": library_ms,
                          f"{key}_bound_ms": bound_ms})
            if key != "train":   # the gradient phase times that one
                stats[f"{key}_ms"] = ms
        print(line)
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
    bound_ms, bound_by, _, _ = convlstm_bound(TRAIN_SHAPE, "bfloat16")
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
    """Least time of one call: its operations (``k2_ops``) on the CUDA
    cores vs its bytes (``k2_bytes``) at the memory bandwidth."""
    ops = k2_ops(*shape, patch_size, num_points)
    nbytes = k2_bytes(*shape, patch_size)
    t_ops, t_bytes = ops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
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
    from windtpu_torch.ops.ks import (
        ascending_thresholds,
        launch_spatial_ks,
        spatial_ks,
    )

    main_err = None
    cases = [("path", KS_SHAPE, KS_ARGS, None),
             ("train_main", KS_TRAIN_MAIN, KS_TRAIN_MAIN_ARGS, None),
             ("ragged", KS_RAGGED, KS_RAGGED_ARGS, None),
             ("path with NaNs", KS_SHAPE, KS_ARGS, "nans"),
             ("path with values on the thresholds", KS_SHAPE, KS_ARGS,
              "ties"),
             ("path, real f32 and fake bf16", KS_SHAPE, KS_ARGS, "bf16"),
             ("lo > hi", KS_RAGGED, dict(KS_RAGGED_ARGS, lo=20.0, hi=-20.0),
              None),
             ("one threshold, patch = H", (1, 2, 12, 20, 1),
              dict(patch_size=12, num_points=1), None),
             ("patch 16, two thresholds per word", (1, 2, 40, 51, 1),
              dict(patch_size=16, num_points=30), "nans"),
             ("train_main rank of 2", KS_TRAIN_RANK, KS_TRAIN_MAIN_ARGS,
              None),
             ("train_main rank of 4", KS_TRAIN_RANK4, KS_TRAIN_MAIN_ARGS,
              None)]
    for i, (name, shape, kw, edit) in enumerate(cases):
        real, fake = ks_inputs(shape, seed=60 + i)
        if edit == "nans":
            real[0, 0, 3:5, 7, 0] = float("nan")
            fake[-1, -1, -1, 10:40, -1] = float("nan")
        elif edit == "ties":
            # Every other value moved onto its nearest threshold.
            torch.manual_seed(60 + i)
            grid = ks_thresholds(kw["num_points"], -30.0, 30.0, "cuda")
            near = grid[torch.bucketize(real, grid).clamp(max=len(grid) - 1)]
            real = torch.where(torch.rand_like(real) < 0.5, near, real)
            fake = torch.where(torch.rand_like(fake) < 0.5, near, fake)
        elif edit == "bf16":
            fake = fake.to(torch.bfloat16)
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
    patch = KS_ARGS["patch_size"]
    # The whole wrapper (thresholds, kernel, mean over the pairs), which
    # is what the training step pays; then the kernel alone on the same
    # tensors.
    ms = cuda_ms(lambda: spatial_ks(real, fake, **KS_ARGS), iters=50)
    points = ascending_thresholds(KS_ARGS["num_points"], -30.0, 30.0,
                                  real.device)
    b, t, h, w, c = KS_SHAPE
    out = torch.empty((b * t * c, h - patch + 1, w - patch + 1),
                      device="cuda")
    kernel_ms = cuda_ms(lambda: launch_spatial_ks(real, fake, points, out,
                                                  patch), iters=50)
    ms_again = cuda_ms(lambda: spatial_ks(real, fake, **KS_ARGS), iters=50)
    plain_ms = cuda_ms(
        lambda: spatially_convolved_ks_stat(real, fake, **KS_ARGS),
        iters=3, warmup=1)
    # No single PyTorch call computes this function.  The nearest
    # yardstick: F.avg_pool2d of the two indicator images, in a loop over
    # the thresholds.
    fr, ff = ks_fields(real).contiguous(), ks_fields(fake).contiguous()

    def yardstick():
        best = torch.zeros((), device="cuda")
        for p in points:
            diff = (F.avg_pool2d((fr[:, None] <= p).float(), patch, stride=1)
                    - F.avg_pool2d((ff[:, None] <= p).float(), patch,
                                   stride=1))
            best = torch.maximum(best, diff.abs())
        return best.mean(dim=0)

    yardstick_ms = cuda_ms(yardstick, iters=3, warmup=1)
    bound_ms, bound_by, ops, nbytes = ks_bound(KS_SHAPE, **KS_ARGS)
    print(f"spatial_ks {KS_SHAPE} {KS_ARGS} (96 field pairs, one launch): "
          f"wrapper {ms:.4f} ms (again {ms_again:.4f} ms; the kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, yardstick "
          f"(avg_pool2d per threshold, not one call) {yardstick_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.3f} G "
          f"operations at {PEAK_FLOPS['float32'] / 1e12:.0f}e12/s, "
          f"{nbytes / 1e6:.1f} MB); wrapper at {ops / ms / 1e9:.2f} "
          f"T operations/s")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_alone_ms": kernel_ms, "yardstick_ms": yardstick_ms}


def layer_norm_bytes(shape, dtype: str, tensors: int) -> int:
    """Bytes a layer-norm stage moves at ``shape``: ``tensors`` reads and
    writes of the map (forward 2, backward 3, double backward 5) and the
    f32 mean and rstd of each row, read or written once."""
    rows, n = int(np.prod(shape[:-1])), shape[-1]
    size = 2 if dtype == "bfloat16" else 4
    return rows * (tensors * n * size + 8)


def layer_norm_host_us(fn, iters: int = 300) -> float:
    """Host microseconds per call of ``fn``, at a map small enough that the
    card keeps up: the loop's wall time before the synchronise."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / iters


def layer_norm_kernel_phase() -> dict:
    """The critic's LayerNorm kernels (forward, backward, double backward)
    against their plain stages at every map of LN_MAPS, per output within
    LN_RTOL and LN_ATOL; each timed on the device's clock alone (a
    replayed graph of calls) beside its byte bound, and at the first map
    of each as eager calls too, beside the plain stages and ATen's layer
    norm (``library_ms``; the port calls it nowhere).  Then the host time
    of an eager call of ``layer_norm`` against ``F.layer_norm``'s, and
    what it adds to a replayed train_main step."""
    import torch
    import torch.nn.functional as F

    from windtpu_torch.ops import layer_norm as ln

    eps, every = 1e-3, (True, True, True)
    names = ("y", "mean", "rstd", "dx", "dgamma", "dbeta", "gdy", "gx",
             "ggamma", "gdy (ggx only)", "gx (ggx only)",
             "ggamma (ggx only)")
    out = {"maps": {}, "max_err_ratio": 0.0}
    for name, (shapes, dtype_name) in LN_MAPS.items():
        dtype = getattr(torch, dtype_name)
        for first, shape in zip((True, False, False, False), shapes):
            g = torch.Generator(device="cuda").manual_seed(70)
            n = shape[-1]
            x, dy, ggx = (torch.randn(shape, generator=g, device="cuda")
                          .to(dtype) for _ in "abc")
            gamma, beta, ggg, ggb = (
                (1.0 + 0.3 * torch.randn(n, generator=g, device="cuda"))
                .to(dtype), *((0.3 * torch.randn(n, generator=g,
                                                 device="cuda")).to(dtype)
                              for _ in "abc"))
            y, mean, rstd = ln._forward(x, gamma, beta, eps, stats=True)
            got = [y, mean, rstd,
                   *ln._backward(dy, x, gamma, mean, rstd, every),
                   *ln._double_backward(dy, x, gamma, mean, rstd, ggx, ggg,
                                        ggb, every),
                   *ln._double_backward(dy, x, gamma, mean, rstd, ggx, None,
                                        None, every)]
            py, pm, pr = ln.forward_plain(x, gamma, beta, eps)
            want = [py, pm, pr,
                    *ln.backward_plain(dy, x, gamma, pm, pr, every),
                    *ln.double_backward_plain(dy, x, gamma, pm, pr, ggx,
                                              ggg, ggb, every),
                    *ln.double_backward_plain(dy, x, gamma, pm, pr, ggx,
                                              None, None, every)]
            torch.cuda.synchronize()
            # Each output's largest |error| over what its limit allows.
            ratios = []
            for a, b in zip(got, want):
                rtol = LN_RTOL[str(a.dtype)[6:]]
                a, b = a.float(), b.float()
                allowed = LN_ATOL * float(b.abs().max()) + rtol * b.abs()
                ratios.append(float(((a - b).abs() / allowed).max()))
            worst = max(ratios)
            out["max_err_ratio"] = max(out["max_err_ratio"], worst)
            print(f"layer_norm {name} {tuple(shape)} {dtype_name}: largest "
                  f"error over its limit per output ("
                  + ", ".join(f"{k} {e:.2f}" for k, e in zip(names, ratios))
                  + ")")
            if worst > 1.0:
                fail(f"layer_norm disagrees with its plain stages at "
                     f"{tuple(shape)} {dtype_name}: "
                     f"{names[ratios.index(worst)]}")

            dx_only = (True, False, False)
            stages = {
                "forward": (2, lambda: ln._forward(x, gamma, beta, eps,
                                                   True)),
                "backward": (3, lambda: ln._backward(dy, x, gamma, mean,
                                                     rstd, dx_only)),
                "backward with dgamma, dbeta": (
                    3, lambda: ln._backward(dy, x, gamma, mean, rstd,
                                            every)),
                "double backward": (
                    5, lambda: ln._double_backward(dy, x, gamma, mean, rstd,
                                                   ggx, None, None, every)),
            }
            if first:
                xg = x.detach().requires_grad_()
                gg = gamma.detach().requires_grad_()
                bg = beta.detach().requires_grad_()
                ref = F.layer_norm(xg, (n,), gg, bg, eps=eps)
                ref_dx, = torch.autograd.grad(ref, xg, dy, create_graph=True)
                others = {
                    "forward": (
                        lambda: ln.forward_plain(x, gamma, beta, eps),
                        lambda: torch.ops.aten.native_layer_norm(
                            x, (n,), gamma, beta, eps)),
                    "backward": (
                        lambda: ln.backward_plain(dy, x, gamma, pm, pr,
                                                  dx_only),
                        lambda: torch.ops.aten.native_layer_norm_backward(
                            dy, x, (n,), mean, rstd, gamma, beta,
                            [True, False, False])),
                    "backward with dgamma, dbeta": (
                        lambda: ln.backward_plain(dy, x, gamma, pm, pr,
                                                  every),
                        lambda: torch.ops.aten.native_layer_norm_backward(
                            dy, x, (n,), mean, rstd, gamma, beta,
                            [True, True, True])),
                    "double backward": (
                        lambda: ln.double_backward_plain(
                            dy, x, gamma, pm, pr, ggx, None, None, every),
                        lambda: torch.autograd.grad(ref_dx, (xg, gg), ggx,
                                                    retain_graph=True)),
                }
            for stage, (tensors, kernel) in stages.items():
                nbytes = layer_norm_bytes(shape, dtype_name, tensors)
                bound = nbytes / PEAK_BYTES * 1e3
                ms = graph_ms(kernel, iters=20)
                row = {"ms": ms, "bound_ms": bound}
                line = (f"layer_norm {name} {tuple(shape)} {stage}: kernel "
                        f"{ms:.4f} ms, bound {bound:.4f} ms "
                        f"({nbytes / 1e6:.1f} MB, {100 * bound / ms:.1f}% "
                        f"of it)")
                if first:
                    plain, library = others[stage]
                    row.update(eager_ms=cuda_ms(kernel, iters=20),
                               plain_ms=cuda_ms(plain, iters=3, warmup=1),
                               library_ms=cuda_ms(library, iters=5,
                                                  warmup=1))
                    line += (f"; eager calls {row['eager_ms']:.4f} ms, "
                             f"plain {row['plain_ms']:.4f} ms, library "
                             f"{row['library_ms']:.4f} ms")
                print(line)
                out["maps"][f"{name} {tuple(shape)} {stage}"] = row

    # Host time per eager call, as the generator update (forward with a
    # graph, backward for the input) and eval (forward without) make
    # them, on a map the card finishes faster than the host calls.
    x, gamma, beta = (t.to("cuda") for t in (
        torch.randn(2, 6, 4, 4, 16), 1.0 + 0.1 * torch.randn(16),
        0.1 * torch.randn(16)))
    xg = x.detach().requires_grad_()
    dy = torch.randn_like(x)
    host = {}
    for who, norm in (("layer_norm", lambda t: ln.layer_norm(t, gamma, beta,
                                                             eps)),
                      ("F.layer_norm", lambda t: F.layer_norm(
                          t, (16,), gamma, beta, eps=eps))):
        y = norm(xg)
        host[who] = {
            "forward": layer_norm_host_us(lambda: norm(xg)),
            "forward, no grad": layer_norm_host_us(
                torch.no_grad()(lambda: norm(x))),
            "backward (input)": layer_norm_host_us(
                lambda: torch.autograd.grad(y, xg, dy, retain_graph=True)),
        }
        print(f"{who}: host us per eager call at (2, 6, 4, 4, 16) f32: "
              + ", ".join(f"{k} {v:.1f}" for k, v in host[who].items()))
    # A replayed train_main step calls 5 forwards with a graph and 5
    # backwards (the generator update) and 10 without (eval).
    calls = {"forward": 5, "backward (input)": 5, "forward, no grad": 10}
    extra = sum(c * (host["layer_norm"][k] - host["F.layer_norm"][k])
                for k, c in calls.items())
    print(f"layer_norm against F.layer_norm: {extra / 1e3:+.3f} ms of host "
          f"a replayed train_main step ({calls})")
    out["host_us"] = host
    out["host_ms_per_train_main_step"] = extra / 1e3
    return out


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
    from windtpu_torch.models.texture_gate import predict_log_energy
    from windtpu_torch.ops.convlstm import convlstm_seq

    # The flagship inference domain (InferenceConfig): 24 h on 21 x 42
    # ERA5 cells -> 546 x 756 px, 63 patches in 4 groups of 16.
    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    network = api.get_network()
    api.downscale(era5, raster, network=network)  # warm-up
    torch.cuda.synchronize()

    counts = {"convlstm_seq": 0}
    convlstm_seq.launches = predict_log_energy.calls = 0
    t0 = time.perf_counter()
    res = api.downscale(era5, raster, network=network)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["convlstm_seq"] = convlstm_seq.launches
    gate = api.last_run_info()["gate"]
    if gate != "device" or predict_log_energy.calls != 1:
        fail(f"the gate's energies were predicted on {gate!r} with "
             f"{predict_log_energy.calls} device predictions; expected "
             f"'device' and 1")

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
    """Two f32 train steps on the card against the CPU, without and with
    the reconstruction loss (its encoder from ``features.get_encoder_fn``
    on each device: random weights of one seed at 24 px, the same on
    both)."""
    from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
    from windtpu_torch.features import get_encoder_fn

    for coefficient in (0.0, RECO_COEFFICIENT):
        cfg = GANConfig(
            model=ModelConfig(image_size=24, sequence_length=4,
                              compute_dtype="float32"),
            train=TrainConfig(batch_size=2, compute_spatial_ks=True,
                              reconstruction_coefficient=coefficient))
        feature_fns = {dev: (get_encoder_fn(24, 4, device=dev)
                             if coefficient > 0 else None)
                       for dev in ("cuda", "cpu")}
        train_step_pair(cfg, feature_fns)


def train_step_pair(cfg, feature_fns,
                    name: str = "training reference") -> None:
    import torch

    from windtpu_torch.train.state import create_train_state
    from windtpu_torch.train.wgan_gp import draw_step_noise, make_train_step
    from windtpu_torch.weights import export_train_state, load_train_state

    batches = train_batches(cfg, 2, seed=2)
    devices = ("cuda", "cpu")
    steps = {dev: make_train_step(cfg, feature_fn=feature_fns[dev])
             for dev in devices}
    states = {dev: create_train_state(cfg, seed=3, device=dev)
              for dev in devices}
    rngs = {dev: torch.Generator().manual_seed(4) for dev in devices}
    seconds = dict.fromkeys(devices, 0.0)
    worst = worst_param = 0.0
    coefficient = cfg.train.reconstruction_coefficient
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
            _, out = steps[dev](states[dev], low_res, high_res, draws=draws)
            metrics[dev] = {k: float(v) for k, v in out.items()}
            seconds[dev] += time.perf_counter() - t0
        if coefficient > 0 and not metrics["cuda"]["g_reco_loss"] > 0:
            fail(f"train step {i + 1}: g_reco_loss "
                 f"{metrics['cuda']['g_reco_loss']!r} with the "
                 f"reconstruction loss on")
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
    print(f"{name}: f32, batch 2, 24 px, T=4, F=128/16, "
          f"reconstruction coefficient {coefficient}"
          + (f" (g_reco_loss {metrics['cuda']['g_reco_loss']:.4f})"
             if coefficient > 0 else "")
          + f", two steps (card {seconds['cuda']:.2f} s, CPU "
          f"{seconds['cpu']:.2f} s), card vs CPU: metrics within "
          f"{worst:.3e} (relative to max(1, |value|)), {len(sample)} "
          f"sampled tensors of the updated state within {worst_param:.3e} "
          f"(tol {REFERENCE_TOL:.0e})")
    if worst_param > REFERENCE_TOL:
        fail("the card's f32 train steps disagree with the CPU's")


# layer_norm's launches through its wrapper in one train step at n_critic
# 3, by the critic's image size and dtype, then (remat, remat_gp): (those
# of the generator update and eval, which every step makes; those of the
# critic updates, which a replayed graph makes without the wrapper and a
# capture makes none of).  Counted on the CPU through the plain stages: one
# launch a forward, a backward one or two (with the gamma and beta sums), a
# double backward one or two (with the gamma gradient).  Remat runs a
# critic call's forward again in its backward.  In float32 gamma and beta
# are the parameters themselves, leaves, whose gradients a backward always
# computes (ops.conv2d_grad._wanted), so more backwards launch two.
LN_STEP_LAUNCHES = {
    (96, "bfloat16"): {(False, False): (20, 129), (True, True): (25, 174),
                       ("save_scans", True): (25, 174),
                       ("d_only", True): (25, 174),
                       ("d_only", False): (25, 144)},
    (96, "float32"): {(False, False): (25, 144), (True, True): (30, 189),
                      ("save_scans", True): (30, 189),
                      ("d_only", True): (30, 189),
                      ("d_only", False): (30, 159)},
    (32, "float32"): {(False, False): (20, 114)},
}


def ln_launches(model, steps: int, replays: int, remat=False,
                remat_gp: bool = False) -> int:
    """layer_norm's launches through its wrapper over ``steps`` train steps
    of the critic of ``model`` (a ModelConfig, or train_main's ModelConfig
    where None), ``replays`` of whose critic updates were replayed graphs
    (LN_STEP_LAUNCHES)."""
    key = ((32, "float32") if model is None
           else (model.image_size, model.compute_dtype))
    eager, critic = LN_STEP_LAUNCHES[key][(remat, remat_gp)]
    return eager * steps + critic * (steps - replays)


def k1_launches(seq: int, steps: int, replays: int, extra: int = 0) -> int:
    """K1's launches through its wrapper over ``steps`` train steps at
    n_critic 3: five generator forwards of ``seq`` steps each (the fakes of
    the three critic updates, the update's, the metrics'), and ``extra``
    more a step; a replayed graph of the critic updates launches their
    three without the wrapper, and its capture launches nothing."""
    return seq * ((5 + extra) * steps - 3 * replays)


def training_path_phase() -> dict:
    import torch

    from windtpu_torch import api
    from windtpu_torch.network import WindDownscalingGAN
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.ops.layer_norm import layer_norm
    from windtpu_torch.train import checkpoint as ckpt
    from windtpu_torch.train import loop
    from windtpu_torch.train.wgan_gp import critic_graph
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
    batches = train_batches(cfg, 1 + TRAIN_STEPS, seed=0)
    seq = cfg.model.sequence_length

    # The warm-up step runs the critic updates once and captures them.
    layer_norm.launches = 0
    loop.train(cfg, batches[:1], 1, state=net.state,
               log_fn=lambda step, metrics: None)       # warm-up
    torch.cuda.synchronize()
    if layer_norm.launches != ln_launches(cfg.model, 1, 0):
        fail(f"the capturing step launched layer_norm "
             f"{layer_norm.launches} times, expected "
             f"{ln_launches(cfg.model, 1, 0)}")
    print(f"train step 1 (captures the critic updates): layer_norm "
          f"launches {layer_norm.launches}")
    before = {name: export_flax_variables(getattr(net, name))
              for name in ("generator", "discriminator")}

    counts = {"convlstm_seq": 0, "spatial_ks": 0}
    convlstm_seq.launches = spatial_ks.launches = layer_norm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log = []

    def log_fn(step, metrics):
        # loop.train converts the metrics to floats before this call, so
        # the step's device work has finished here.
        log.append((step, time.perf_counter(), convlstm_seq.launches,
                    spatial_ks.launches, layer_norm.launches,
                    critic_graph.replays, metrics))

    timed_cfg = dataclasses.replace(cfg, checkpoint_dir=str(ckpt_dir))
    captures, replays = critic_graph.captures, critic_graph.replays
    t0 = time.perf_counter()
    loop.train(timed_cfg, batches[1:1 + TRAIN_STEPS], TRAIN_STEPS,
               state=net.state, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    counts["convlstm_seq"] = convlstm_seq.launches
    counts["spatial_ks"] = spatial_ks.launches
    counts["layer_norm"] = layer_norm.launches
    peak = torch.cuda.max_memory_allocated()

    if [entry[0] for entry in log] != list(range(2, 2 + TRAIN_STEPS)):
        fail(f"logged steps {[entry[0] for entry in log]}")
    # The warm-up step captured the critic updates; every timed step
    # replays them.
    made = (critic_graph.captures - captures, critic_graph.replays - replays)
    if made != (0, TRAIN_STEPS):
        fail(f"the timed steps made {made[0]} captures and {made[1]} "
             f"replays of the critic updates, expected (0, {TRAIN_STEPS})")
    last_t, last_k1, last_k2, last_ln, last_r = t0, 0, 0, 0, replays
    for step, t, k1, k2, n_ln, r, metrics in log:
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            fail(f"step {step}: metrics {bad} are not finite")
        if not 0.0 <= metrics["g_spatial_ks"] <= 1.0:
            fail(f"step {step}: g_spatial_ks {metrics['g_spatial_ks']}")
        want = k1_launches(seq, 1, r - last_r)
        if k1 - last_k1 != want or k2 - last_k2 != 1:
            fail(f"step {step}: convlstm_seq launched {k1 - last_k1} times "
                 f"(expected {want}: {r - last_r} replays of the critic "
                 f"updates) and spatial_ks {k2 - last_k2} (expected 1)")
        want = ln_launches(cfg.model, 1, r - last_r)
        if n_ln - last_ln != want:
            fail(f"step {step}: layer_norm launched {n_ln - last_ln} times "
                 f"(expected {want}: {r - last_r} replays of the critic "
                 f"updates)")
        shown = {k: round(metrics[k], 4) for k in (
            "g_loss", "d_loss", "d_gradient_pen", "g_ws_rmse",
            "g_spatial_ks")}
        print(f"train step {step}: {t - last_t:.3f} s, convlstm_seq "
              f"launches {k1 - last_k1}, critic graph replays "
              f"{r - last_r}, spatial_ks launches {k2 - last_k2}, "
              f"layer_norm launches {n_ln - last_ln}, {shown}")
        last_t, last_k1, last_k2, last_ln, last_r = t, k1, k2, n_ln, r
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
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return counts


def merged_field(era5, raster):
    """The (T, H, W, 3) field that ``api.predict`` tiles, on the host."""
    from windtpu_torch.infer.template import (
        build_high_res_template_from_era5,
        process_era5,
        process_topo,
    )

    template = build_high_res_template_from_era5(era5)
    inputs = process_era5(era5, template)
    elev = np.asarray(process_topo(raster, template)["elevation"].values,
                      np.float32) / 1e3
    u10 = np.asarray(inputs["u10"].values, np.float32)
    v10 = np.asarray(inputs["v10"].values, np.float32)
    return np.stack([u10, v10, np.broadcast_to(elev, u10.shape)], axis=-1)


def compare(name: str, got, want, atol: float, rtol: float = 0.0,
            mean_tol: float = None) -> float:
    """Fail unless ``got`` and ``want`` have the same NaN cells and agree
    within atol + rtol |want| (and, with ``mean_tol``, on average within
    it); returns the max abs difference."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape:
        fail(f"{name}: shape {got.shape} != {want.shape}")
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        fail(f"{name}: the NaN cells differ")
    m = ~np.isnan(want)
    diff = np.abs(got[m] - want[m])
    err = float(diff.max())
    excess = float(np.max(diff - rtol * np.abs(want[m])))
    mean = float(diff.mean())
    ok = (m.any() and np.isfinite(got[m]).all() and excess <= atol
          and (mean_tol is None or mean <= mean_tol))
    limit = "" if mean_tol is None else f", mean tol {mean_tol:.1e}"
    print(f"{name}: max_abs_err {err:.3e}, mean {mean:.3e} (tol {atol:.1e} "
          f"+ {rtol:.0e} x |value|{limit}, output scale "
          f"{float(np.abs(want[m]).max()):.2f}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagree")
    return err


def timed(fn):
    """(result, seconds, K1 launches) of one call, ending in a sync."""
    import torch

    from windtpu_torch.ops.convlstm import convlstm_seq

    torch.cuda.synchronize()
    convlstm_seq.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, convlstm_seq.launches


def streaming_path_phase() -> dict:
    import torch

    from windtpu_torch import api
    from windtpu_torch.core.config import InferenceConfig
    from windtpu_torch.infer import engine, streaming
    from windtpu_torch.network import WindDownscalingGAN

    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    patches, groups, seq = 63, 4, 24
    network = api.get_network()
    kw = dict(network=network, seed=0)
    mono = api.downscale(era5, raster, streaming=False, **kw)  # warm-up
    # Host time by function of one streamed call (also its warm-up).
    profile_host(lambda: api.downscale(era5, raster, streaming=True, **kw))

    # The paths, through the entry point; each counted on its own.  The
    # 4-member ensemble runs monolithic as users call it (gate "auto", on
    # the device), then monolithic and streamed without the gate, which
    # the two hold against each other: on the streamed path the gate is
    # the host's numpy FFTs, once per member, and the one-member runs
    # already hold it against the device's.
    counts = {}
    runs = {}
    for path, name, extra in [
            ("streaming", "streamed", dict(streaming=True)),
            ("ensemble", f"monolithic, {MEMBERS} members",
             dict(streaming=False, ensemble_members=MEMBERS)),
            ("ensemble", f"monolithic, {MEMBERS} members, gate off",
             dict(streaming=False, ensemble_members=MEMBERS,
                  texture_gate=False)),
            ("ensemble", f"streamed, {MEMBERS} members, gate off",
             dict(streaming=True, ensemble_members=MEMBERS,
                  texture_gate=False))]:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, seconds, k1 = timed(lambda: api.downscale(era5, raster, **kw,
                                                        **extra))
        peak = torch.cuda.max_memory_allocated() - base
        info = api.last_run_info()
        want_mode = ("streaming" if extra["streaming"] else "ensemble")
        want_gate = extra.get("texture_gate", True)
        want_route = (("host" if extra["streaming"] else "device")
                      if want_gate else None)
        members = extra.get("ensemble_members", 1)
        if (info["mode"] != want_mode or info["texture_gate"] != want_gate
                or info["gate"] != want_route or k1 != groups * seq):
            fail(f"downscale ({name}) ran {info} with {k1} convlstm_seq "
                 f"launches; expected {want_mode!r}, gate {want_gate} "
                 f"predicted on {want_route!r} and {groups * seq}")
        u = res["u10"].values
        want_shape = ((members,) if members > 1 else ()) + (24, 542, 752)
        if u.shape != want_shape or not np.isfinite(u).all():
            fail(f"downscale ({name}): u10 {u.shape}, finite "
                 f"{np.isfinite(u).all()}")
        counts[path] = counts.get(path, 0) + k1
        runs[name] = res
        print(f"downscale {name} (24 h x 546 x 756, {patches} patches x "
              f"{members}): {seconds:.3f} s, {members * patches / seconds:.1f}"
              f" patches/s, convlstm_seq launches {k1}, peak device memory "
              f"above the weights {peak / 2**20:.1f} MiB")
    pairs = [("streamed vs monolithic", runs["streamed"], mono),
             (f"{MEMBERS} members streamed vs monolithic, gate off",
              runs[f"streamed, {MEMBERS} members, gate off"],
              runs[f"monolithic, {MEMBERS} members, gate off"])]
    for name, got, want in pairs:
        for var in ("u10", "v10"):
            w = want[var].values
            compare(f"bf16 downscale {var}, {name}", got[var].values, w,
                    STREAM_BF16_REL * float(np.nanmax(np.abs(w))),
                    mean_tol=STREAM_BF16_MEAN_TOL)
    ens = runs[f"monolithic, {MEMBERS} members"]["u10"].values
    spread = float(np.min([np.abs(ens[m] - ens[0]).mean()
                           for m in range(1, MEMBERS)]))
    print(f"members differ: least mean |u10 member m - member 0| "
          f"{spread:.4f} m/s")
    if not spread > 1e-3:
        fail("the ensemble's members do not differ")

    # Engine level, from the same merged field.
    field = merged_field(era5, raster)
    mcfg = network.cfg.model
    icfg = InferenceConfig(sequence_length=24, image_size=96,
                           noise_channels=mcfg.noise_channels)
    cfg32 = dataclasses.replace(network.cfg, model=dataclasses.replace(
        mcfg, compute_dtype="float32"))
    net32 = WindDownscalingGAN(cfg32).load_weights(api.BUNDLED_GENERATOR)
    f32_mono, _ = engine.downscale_field(net32.generator, field,
                                         cfg32.model, icfg, generator=3)
    f32_stream, _ = streaming.downscale_field_streaming(
        net32.generator, field, cfg32.model, icfg, generator=3)
    compare("f32 engine, streamed vs monolithic", f32_stream,
            f32_mono.cpu().numpy(), STREAM_ATOL, STREAM_RTOL)
    del net32, f32_mono
    bf16_icfg = dataclasses.replace(icfg,
                                    streaming_transfer_dtype="bfloat16")
    by_transfer = {}
    for name, cfg in (("f32", icfg), ("bf16", bf16_icfg)):
        print(f"streamed engine, {name} transfers:")
        by_transfer[name] = profile_transfers(
            lambda: streaming.downscale_field_streaming(
                network.generator, field, mcfg, cfg, generator=5)[0])
    compare("bf16 engine, bf16 vs f32 transfers", by_transfer["bf16"],
            by_transfer["f32"], TRANSFER_BF16_TOL)
    seeds = api.member_seeds(7, MEMBERS)
    fused, _ = engine.downscale_field(network.generator, field, mcfg, icfg,
                                      ensemble_generators=seeds)
    for m, s in enumerate(seeds):
        single, _ = engine.downscale_field(network.generator, field, mcfg,
                                           icfg, generator=s)
        compare(f"bf16 engine, member {m} vs its one-member run",
                fused[m].cpu().numpy(), single.cpu().numpy(), MEMBER_TOL)
    del fused, single

    # Streamed peak memory at a part of the flagship domain (16 patches) and
    # at the whole (63, about 4x).
    peaks = []
    for f in (field[:, :330, :378], field):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (_, plan), seconds, k1 = timed(
            lambda: streaming.downscale_field_streaming(
                network.generator, f, mcfg, icfg, generator=0))
        peaks.append(torch.cuda.max_memory_allocated() - base)
        print(f"streamed engine {f.shape[1]} x {f.shape[2]} "
              f"({plan.num_patches} patches): {seconds:.3f} s, "
              f"{plan.num_patches / seconds:.1f} patches/s, convlstm_seq "
              f"launches {k1}, peak device memory above the weights "
              f"{peaks[-1] / 2**20:.1f} MiB")
    if peaks[1] > peaks[0] + (16 << 20):
        fail(f"streamed peak memory grows with the domain: "
             f"{peaks[0] / 2**20:.1f} -> {peaks[1] / 2**20:.1f} MiB")
    threshold_measurements(network, icfg)
    return counts


def threshold_measurements(network, icfg) -> None:
    """Peak device memory of the monolithic engine plus the device texture
    gate at THRESHOLD_DOMAINS against ``api._engine_hbm_bytes``, the
    target energies predicted from the device field first, as
    ``api.predict`` does; fails if that prediction leaves more than its
    two energies allocated or peaks above the engine and gate after it, if
    the linear fit of the one-member points puts the default threshold's
    peak above THRESHOLD_SHARE of the card's memory, or if the ensemble's
    measured peak is above it."""
    import torch

    from windtpu_torch import api
    from windtpu_torch.infer.engine import make_tiled_predictor
    from windtpu_torch.infer.tiling import plan_tiling
    from windtpu_torch.models.texture_gate import predict_log_energy

    gate = network.texture_gate
    floor = torch.as_tensor(np.asarray(gate["floor"], np.float32),
                            device="cuda")
    # The first prediction in a process leaves 32 MiB allocated on an
    # H100 80GB HBM3, the workspace of the MLP's first matmul, which later
    # calls reuse: make it before measuring.
    predict_log_energy(gate, torch.ones((24, 96, 96, 3), device="cuda"))
    mcfg = network.cfg.model
    total = torch.cuda.get_device_properties(0).total_memory
    points = []
    for h, w, members in THRESHOLD_DOMAINS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gens = [torch.Generator(device="cuda").manual_seed(m)
                for m in range(members)]
        field = torch.randn((24, h, w, 3), generator=gens[0], device="cuda")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        target = torch.exp(predict_log_energy(gate, field))
        torch.cuda.synchronize()
        gate_peak = torch.cuda.max_memory_allocated() - base
        left = torch.cuda.memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        plan = plan_tiling(h, w, 24, 96, 24, icfg.overlap_factor)
        pred, _ = make_tiled_predictor(mcfg, icfg, plan, network.generator,
                                       "cuda")(
            field, gens if members > 1 else gens[0])
        pred = api._trim_canvas(pred, plan, icfg)
        api._gate_members_on_device(target, floor, pred, members > 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        engine_peak = torch.cuda.max_memory_allocated() - base
        peak = max(gate_peak, engine_peak)
        est = api._engine_hbm_bytes(24, h, w, 3, 2, members)
        if not bool(torch.isfinite(pred).all()):
            fail(f"monolithic engine at {h} x {w}: output not finite")
        del field, pred
        print(f"monolithic engine + gate, {members} member(s), 24 x {h} x "
              f"{w} ({plan.num_patches} patches): {seconds:.2f} s, peak "
              f"device memory above the weights {peak / 2**30:.3f} GiB "
              f"({100 * peak / total:.1f}% of the card), _engine_hbm_bytes "
              f"{est / 2**30:.3f} GiB, ratio {peak / est:.3f}; the energy "
              f"prediction before it peaked at {gate_peak / 2**30:.3f} GiB "
              f"(field included) and left {left} bytes")
        if left > (1 << 20) or gate_peak > engine_peak:
            fail(f"the gate's energy prediction at {h} x {w} left {left} "
                 f"bytes allocated and peaked at {gate_peak / 2**30:.3f} "
                 f"GiB against the engine's {engine_peak / 2**30:.3f} GiB")
        if members == 1:
            points.append((est, peak))
        elif peak > THRESHOLD_SHARE * total:
            fail(f"{members} members at {h} x {w} peaked above "
                 f"{THRESHOLD_SHARE:.0%} of the card's memory")
    torch.cuda.empty_cache()
    est, peak = (np.array(v, np.float64) for v in zip(*points))
    slope, intercept = np.polyfit(est, peak, 1)
    default = api._STREAMING_DEFAULT_BYTES
    at_default = slope * default + intercept
    at_card = (total - intercept) / slope
    print(f"fit: peak = {slope:.3f} x _engine_hbm_bytes + "
          f"{intercept / 2**30:.3f} GiB; at the default threshold "
          f"{default / 2**30:.2f} GiB: {at_default / 2**30:.2f} GiB of "
          f"{total / 2**30:.2f} GiB ({100 * at_default / total:.1f}%); the "
          f"card's memory is reached at {at_card / 2**30:.2f} GiB")
    if at_default > THRESHOLD_SHARE * total:
        fail(f"the default streaming threshold would peak above "
             f"{THRESHOLD_SHARE:.0%} of the card's memory")


def profile_transfers(fn):
    """Device milliseconds of the host-to-device and device-to-host copies
    of one call of ``fn`` (torch.profiler), beside its wall time; returns
    what ``fn`` returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    if not rows:
        print("transfer profile: no device time recorded (not measured)")
        return out
    busy = sum(e.device_time_total for e in rows) / 1e3
    print(f"transfer profile: wall {wall * 1e3:.1f} ms, device {busy:.1f} "
          f"ms ({100 * busy / (wall * 1e3):.1f}% busy)")
    for e in rows:
        if "Memcpy" in e.key:
            print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key}")
    return out


def train_entry_phase() -> dict:
    import torch

    from windtpu_torch import cli
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.ops.layer_norm import layer_norm
    from windtpu_torch.train.wgan_gp import critic_graph

    ckpt_root = ROOT / "build" / "chip_smoke_train_main"

    def run(steps: int):
        directory = ckpt_root / str(steps)
        shutil.rmtree(directory, ignore_errors=True)
        return cli.train_main(TRAIN_ENTRY_ARGV + [
            "--checkpoint-dir", str(directory), "--steps", str(steps)])

    run(1)                                               # warm-up
    walls = {}
    for steps in TRAIN_MAIN_STEPS:
        convlstm_seq.launches = spatial_ks.launches = layer_norm.launches = 0
        captures, replays = critic_graph.captures, critic_graph.replays
        torch.cuda.reset_peak_memory_stats()
        state, walls[steps], k1 = timed(lambda: run(steps))
        k2, n_ln = spatial_ks.launches, layer_norm.launches
        made = (critic_graph.captures - captures,
                critic_graph.replays - replays)
        if state.step != steps:
            fail(f"train_main stopped at step {state.step} of {steps}")
        seq = state.generator.config.sequence_length
        # A new state: its first step captures the critic updates, the
        # others replay them.
        want = k1_launches(seq, steps, steps - 1)
        want_ln = ln_launches(state.generator.config, steps, steps - 1)
        if (k1 != want or k2 != steps or n_ln != want_ln
                or made != (1, steps - 1)):
            fail(f"train_main, {steps} steps: convlstm_seq launched {k1} "
                 f"times (expected {want}), spatial_ks {k2} (expected "
                 f"{steps}), layer_norm {n_ln} (expected {want_ln}), "
                 f"critic graph captures and replays {made} (expected "
                 f"{(1, steps - 1)})")
        print(f"train_main --synthetic, batch 16 x T=6 x 32 px, F=128, "
              f"{steps} steps: {walls[steps]:.3f} s, convlstm_seq launches "
              f"{k1}, critic graph captures {made[0]} and replays "
              f"{made[1]}, spatial_ks launches {k2}, layer_norm launches "
              f"{n_ln}, peak memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    a, b = TRAIN_MAIN_STEPS
    print(f"train_main: {(walls[b] - walls[a]) / (b - a):.4f} s per step "
          f"(the difference of the two runs over {b - a} steps)")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return {"convlstm_seq": k1, "spatial_ks": k2, "layer_norm": n_ln}


def fabricate_dem(path: Path, seed: int):
    """A DEM GeoTIFF over the COSMO-1 window at 3 arc-seconds, from
    ``seed``: a coarse random relief upsampled 40x, clipped to 190-4,800 m,
    with roughness, a 600 m cliff and rectangular NaN holes of 3 to 40 px.
    Returns its shape."""
    from scipy.ndimage import zoom

    from windtpu_torch.assets import swiss_cosmo_grid
    from windtpu_torch.io.geotiff import write_geotiff_like

    grid = swiss_cosmo_grid()
    lat, lon = grid["lat_1"].values, grid["lon_1"].values
    ny = int(np.ceil((lat.max() - lat.min()) / DEM_STEP_DEG)) + 1
    nx = int(np.ceil((lon.max() - lon.min()) / DEM_STEP_DEG)) + 1
    y = lat.max() - DEM_STEP_DEG * np.arange(ny)      # north-up
    x = lon.min() + DEM_STEP_DEG * np.arange(nx)
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((ny // 40 + 2, nx // 40 + 2))
    relief = zoom(coarse, 40, order=1)[:ny, :nx]
    dem = np.clip(1800.0 + 1100.0 * relief, 190.0, 4800.0)
    dem += 15.0 * rng.standard_normal((ny, nx))
    dem[:, nx // 2:] += 600.0 * (np.arange(ny) > ny // 2)[:, None]
    dem = dem.astype(np.float32)
    for _ in range(DEM_HOLES):
        h, w = rng.integers(3, 41, size=2)
        r, c = rng.integers(0, ny - h), rng.integers(0, nx - w)
        dem[r:r + h, c:c + w] = np.nan
    path.parent.mkdir(parents=True, exist_ok=True)
    write_geotiff_like(path, dem, x, y)
    return dem.shape


def fabricate_days(root: Path, days, seed: int) -> None:
    """COSMO-1 days (U_10M, V_10M, 24 h on the 294 x 429 grid with its 2-D
    lat_1/lon_1) and ERA5 days (surface u10, v10, blh, fsr, sp and 500 hPa
    z, vo, d at 0.25 deg over the window), from ``seed``."""
    from windtpu_torch.assets import swiss_cosmo_grid
    from windtpu_torch.io.dataset import DataArray, Dataset

    grid = swiss_cosmo_grid()
    ny, nx = grid["lat_1"].values.shape
    lat = np.arange(48.5, 45.0, -0.25)
    lon = np.arange(5.0, 11.5, 0.25)
    rng = np.random.default_rng(seed)
    (root / "cosmo").mkdir(parents=True, exist_ok=True)
    (root / "era5").mkdir(parents=True, exist_ok=True)
    surface = {"u10": (2.0, 4.0), "v10": (0.0, 4.0), "blh": (600.0, 300.0),
               "fsr": (0.5, 0.2), "sp": (85000.0, 5000.0)}
    z500 = {"z": (55000.0, 500.0), "vo": (0.0, 1e-5), "d": (0.0, 1e-5)}
    for day in days:
        stamp = day.replace("-", "")
        time_ = (np.datetime64(f"{day}T00", "h")
                 + np.arange(24).astype("timedelta64[h]"))
        dims = ("time", "y_1", "x_1")
        Dataset(
            {v: DataArray(dims, (3.0 * rng.standard_normal((24, ny, nx)))
                          .astype(np.float32)) for v in ("U_10M", "V_10M")},
            {"time": DataArray(("time",), time_), **grid.coords},
        ).to_netcdf(root / "cosmo" / f"{stamp}.nc")
        for name, variables in (("surface", surface), ("z500", z500)):
            Dataset(
                {v: DataArray(("time", "latitude", "longitude"), (
                    mean + std * rng.standard_normal(
                        (24, len(lat), len(lon)))).astype(np.float32))
                 for v, (mean, std) in variables.items()},
                {"time": DataArray(("time",), time_),
                 "latitude": DataArray(("latitude",), lat),
                 "longitude": DataArray(("longitude",), lon)},
            ).to_netcdf(root / "era5" / f"{stamp}_era5_{name}_hourly.nc")


def compare_descriptors(card_dir: Path, cpu_dir: Path) -> None:
    """The eight descriptor files of the card's topo run against the CPU's:
    elevation, TPI and ridge norm within TOPO_M_TOL metres, the derivatives
    and the slope within TOPO_DERIVATIVE_TOL, the aspect's error times the
    gradient's length within TOPO_DERIVATIVE_TOL (the angle of a vanishing
    gradient is ill-conditioned), the ridge direction exactly where the
    two largest directional responses differ by more than 1e-3 m."""
    import torch

    from windtpu_torch.io.dataset import open_dataset
    from windtpu_torch.ops import stencil
    from windtpu_torch.preprocess.topo import NAMES

    card, cpu = {}, {}
    for name in NAMES:
        card[name] = open_dataset(card_dir / f"topo_{name}.nc")[name].values
        ds = open_dataset(cpu_dir / f"topo_{name}.nc")
        cpu[name] = ds[name].values
    res_y, res_x = stencil.meters_per_pixel(ds["y"].values, ds["x"].values)
    scale_px = max(int(round(500.0 / abs(res_x))), 1)
    grad = np.hypot(cpu["we_derivative"], cpu["sn_derivative"])
    for name in NAMES:
        a, b = card[name], cpu[name]
        if not np.isfinite(a).all():
            fail(f"topo {name}: not finite on the card")
        if name == "ridge_index_dir":
            elev = torch.from_numpy(cpu["elevation"]).cuda()
            kernels = np.stack([stencil._line_kernel(scale_px, t)
                                for t in np.arange(4) * np.pi / 4])
            resp = torch.clamp(elev[None] - stencil._masked_mean(
                elev, kernels), min=0.0)
            top2 = torch.topk(resp, 2, dim=0).values
            clear = ((top2[0] - top2[1]) > 1e-3).cpu().numpy()
            differ = int(np.count_nonzero(a[clear] != b[clear]))
            print(f"topo {name}: {differ} differences outside near-ties "
                  f"({100 * (1 - clear.mean()):.3f}% of pixels are within "
                  f"1e-3 m of a tie)")
            if differ:
                fail(f"topo {name}: the card and the CPU disagree off "
                     f"near-ties")
            continue
        if name == "aspect":
            diff = np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))
            err = float((grad * diff).max())
            tol, what = TOPO_DERIVATIVE_TOL, "|grad z| x angle error"
        else:
            err = float(np.abs(a - b).max())
            tol, what = ((TOPO_M_TOL, "m") if name in (
                "elevation", "tpi_500", "ridge_index_norm")
                else (TOPO_DERIVATIVE_TOL, "max_abs_err"))
        print(f"topo {name}: card vs CPU {what} {err:.3e} (tol {tol:.0e})")
        if err > tol:
            fail(f"topo {name}: the card disagrees with the CPU")


def prepare_path_phase() -> dict:
    """``prepare topo`` of a DEM over the COSMO-1 window on the card (under
    PyTorch's default TF32 settings) and on the CPU, ``prepare daily`` of
    two days, then ``train_main`` on those days with the reconstruction
    loss at the geometry where the bundled encoder loads."""
    import contextlib
    import json
    import os

    import torch

    from windtpu_torch import cli, features
    from windtpu_torch.io.dataset import open_dataset
    from windtpu_torch.ops import stencil
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.train.wgan_gp import critic_graph

    work = ROOT / "build" / "chip_smoke_prepare"
    shutil.rmtree(work, ignore_errors=True)
    os.environ["CHECKPOINT_ROOT"] = str(work / "no_checkpoints")
    t0 = time.perf_counter()
    shape = fabricate_dem(work / "card" / "dem.tif", seed=11)
    (work / "cpu").mkdir()
    shutil.copy(work / "card" / "dem.tif", work / "cpu" / "dem.tif")
    fabricate_days(work, PREPARE_DAYS, seed=12)
    print(f"fabricated a {shape[0]} x {shape[1]} DEM "
          f"({shape[0] * shape[1] / 1e6:.1f} Mpx, 3 arc-seconds) and "
          f"{len(PREPARE_DAYS)} ERA5 + COSMO-1 days in "
          f"{time.perf_counter() - t0:.1f} s")

    # The topo job on the card under PyTorch's defaults (cuDNN TF32 on,
    # cuBLAS TF32 off), which the stencils must not depend on; this
    # script turns TF32 off everywhere else.
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        seconds = {}
        for dev in ("card", "cpu"):
            argv = ["topo", "--dem", str(work / dev / "dem.tif")]
            if dev == "cpu":
                argv += ["--device", "cpu"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(None):
                cli.prepare_main(argv)
            torch.cuda.synchronize()
            seconds[dev] = time.perf_counter() - t0
        # The trap the stencils avoid: the TPI with their full-f32 scope
        # taken away, under the same defaults.
        dem = torch.from_numpy(open_dataset(
            work / "cpu" / "topo_elevation.nc")["elevation"].values).cuda()
        scale_px = 8          # 500 m at 3 arc-seconds
        scoped = stencil.tpi(dem, scale_px)
        real_scope = stencil._full_f32
        stencil._full_f32 = contextlib.nullcontext
        try:
            unscoped = stencil.tpi(dem, scale_px)
        finally:
            stencil._full_f32 = real_scope
        tf32_err = float((unscoped - scoped).abs().max())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    print(f"prepare topo, {shape[0]} x {shape[1]} px: card {seconds['card']:.2f} "
          f"s, CPU {seconds['cpu']:.2f} s (read, fill, stencils, eight "
          f"NetCDF files written); under cuDNN's TF32 default a TPI "
          f"without the stencils' full-f32 scope would differ by "
          f"{tf32_err:.3e} m")
    compare_descriptors(work / "card", work / "cpu")

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        cli.prepare_main(["daily", "--processed", str(work / "days"),
                          "--era5", str(work / "era5"), "--cosmo",
                          str(work / "cosmo"), "--dem-dir",
                          str(work / "card"), "--start", PREPARE_DAYS[0],
                          "--end", PREPARE_DAYS[-1]])
    daily_seconds = time.perf_counter() - t0
    written = sorted(p.name for p in (work / "days").iterdir())
    want = sorted(f"{k}_{d.replace('-', '')}.nc" for k in "xy"
                  for d in PREPARE_DAYS)
    if written != want:
        fail(f"prepare daily wrote {written}, expected {want}")
    print(f"prepare daily, {len(PREPARE_DAYS)} days of 24 x 294 x 429: "
          f"{daily_seconds:.2f} s")

    def run(steps: int):
        directory = work / f"ck_{steps}"
        shutil.rmtree(directory, ignore_errors=True)
        with contextlib.redirect_stdout(None):
            state = cli.train_main([
                "--inputs", str(work / "days"), "--outputs",
                str(work / "days"), "--checkpoint-dir", str(directory),
                "--steps", str(steps), "--batch-size", "2",
                "--patch-size", "96", "--sequence-length", "24",
                "--reconstruction-coefficient", str(RECO_COEFFICIENT)])
        logged = json.loads(
            (directory / "metrics.jsonl").read_text().splitlines()[0])
        return state, logged

    run(1)                                               # warm-up
    walls, counts = {}, {"convlstm_seq": 0, "spatial_ks": 0,
                         "layer_norm": 0}
    for steps in PREPARE_TRAIN_STEPS:
        convlstm_seq.launches = spatial_ks.launches = layer_norm.launches = 0
        replays = critic_graph.replays
        torch.cuda.reset_peak_memory_stats()
        (state, logged), walls[steps], k1 = timed(lambda: run(steps))
        peak = torch.cuda.max_memory_allocated()
        seq = state.generator.config.sequence_length
        if state.step != steps:
            fail(f"train_main stopped at step {state.step} of {steps}")
        want = k1_launches(seq, steps, critic_graph.replays - replays)
        if k1 != want or spatial_ks.launches:
            fail(f"train_main on prepared days, {steps} steps: "
                 f"convlstm_seq launched {k1} times (expected {want}), "
                 f"spatial_ks {spatial_ks.launches} (expected 0)")
        reco = logged["g_reco_loss"]
        if not (np.isfinite(reco) and reco > 0
                and all(np.isfinite(v) for v in logged.values())):
            fail(f"train_main on prepared days: step 1 metrics {logged}")
        counts["convlstm_seq"] += k1
        counts["layer_norm"] += layer_norm.launches
        print(f"train_main on the prepared days, batch 2 x T=24 x 96 px, "
              f"F=128, f32, reconstruction coefficient {RECO_COEFFICIENT}, "
              f"{steps} steps: {walls[steps]:.3f} s, convlstm_seq launches "
              f"{k1} ({k1 // steps} per step), g_reco_loss {reco:.4f}, "
              f"peak memory allocated {peak / 2**20:.0f} MiB")
    profile_device(lambda: run(PREPARE_TRAIN_STEPS[0]))
    source = features.get_encoder_fn(96, 24, device="cuda").source
    if source != str(features.BUNDLED_AUTOENCODER):
        fail(f"the perceptual loss's encoder came from {source}, not the "
             f"bundled weights")
    a, b = PREPARE_TRAIN_STEPS
    print(f"train_main with the reconstruction loss: "
          f"{(walls[b] - walls[a]) / (b - a):.4f} s per step (the "
          f"difference of the two runs over {b - a} steps); encoder "
          f"{Path(source).name}")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def run_ranks(job: str, world: int, backend: str, out: Path,
              fault: str = "", steps: int = MULTI_STEPS,
              torchrun: bool = False) -> list:
    """Start ``world`` rank processes of this script (``--rank job ...``),
    joined over a free local port with ``backend`` and with ``fault``
    planted, a train job taking ``steps`` steps; wait for them, stop them
    all if one fails, and return their reports.  With ``torchrun`` each
    rank finds its place as under ``torchrun --nproc-per-node world``, in
    RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, and a train
    job passes no coordinator flags."""
    import os

    from windtpu_torch.utils.hostcpu import free_tcp_port

    out.mkdir(parents=True, exist_ok=True)
    port = free_tcp_port()
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = []
    for r in range(world):
        env = dict(os.environ)
        if torchrun:
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", job,
             str(r), str(world), str(port), str(out), backend, fault,
             str(steps), "torchrun" if torchrun else "flags"],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT, env=env))
    deadline = time.monotonic() + MULTI_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.returncode not in (None, 0) for p in procs)):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"rank{r}.log").read_text()[-3000:]
            fail(f"{job} rank {r} of {world} ({backend}) exited with "
                 f"{p.returncode}:\n{tail}")
    warnings = sorted({line.strip() for r in range(world) for line in
                       (out / f"rank{r}.log").read_text().splitlines()
                       if "warn" in line.lower()})
    for line in warnings:
        print(f"  {job} ({backend}, {world} ranks) rank log: {line[:300]}")
    return [json.loads((out / f"report{r}.json").read_text())
            for r in range(world)]


def plant_fault(fault: str) -> None:
    """Break this process's multi-GPU training in one of MULTI_FAULTS, by
    replacing a function of the port in memory: every all-reduce mean of
    the train step (gradients, losses, metrics) becomes a sum, or the
    generator's BatchNorm takes each rank's own batch statistics in the
    global-batch step."""
    import torch.distributed as dist

    from windtpu_torch.models.generator import Generator
    from windtpu_torch.train import wgan_gp

    if fault == MULTI_FAULTS[0]:
        mean = wgan_gp.pmean

        def summed(tensors, group):
            n = 1 if group is None else dist.get_world_size(group)
            return [t * n for t in mean(tensors, group)]
        wgan_gp.pmean = summed
    elif fault == MULTI_FAULTS[1]:
        forward = Generator.forward
        Generator.forward = (lambda self, image, noise, train=False,
                             group=None, **kw: forward(self, image, noise,
                                                       train, **kw))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def time_all_reduces():
    """Wrap ``torch.distributed.all_reduce``, which every all-reduce of the
    port calls, with CUDA events around each call on a CUDA tensor: the
    span from the stream's work before the call to the reduced result,
    waiting for the slowest rank included.  Returns the list it fills,
    (start, end, shape, dtype, group) per call, and the unwrapped
    function."""
    import torch
    import torch.distributed as dist

    spans = []
    inner = dist.all_reduce

    def timed(tensor, *args, **kwargs):
        if not tensor.is_cuda:
            return inner(tensor, *args, **kwargs)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        work = inner(tensor, *args, **kwargs)
        end.record()
        spans.append((start, end, tuple(tensor.shape), tensor.dtype,
                      kwargs.get("group")))
        return work

    dist.all_reduce = timed
    return spans, inner


def replay_all_reduces(calls, all_reduce, device, iters: int = 10) -> float:
    """ms of ``calls`` ((shape, dtype, group) each) all-reduced back to
    back on zero-filled tensors after a barrier, the mean of ``iters``
    rounds after a warm-up: what the collectives take without a slower
    rank to wait for."""
    import torch
    import torch.distributed as dist

    bufs = [(torch.zeros(shape, dtype=dtype, device=device), group)
            for shape, dtype, group in calls]

    def once():
        for buf, group in bufs:
            all_reduce(buf, group=group)

    once()
    dist.barrier(device_ids=[device.index]
                 if dist.get_backend() == "nccl" else None)
    return cuda_ms(once, iters, warmup=0)


def time_train_steps(spans) -> dict:
    """Wrap the train step that ``train.loop.train`` builds so that each
    call records the host clock and the all-reduces timed so far
    (``spans``) as it starts.  Returns the dict it fills: "starts",
    (seconds, span index) per step, and "cfg", the step's GANConfig."""
    from windtpu_torch.train import loop

    record = {"starts": [], "cfg": None}
    make = loop.make_train_step

    def make_timed(cfg, *args, **kwargs):
        step = make(cfg, *args, **kwargs)
        record["cfg"] = cfg

        def timed(*a, **k):
            record["starts"].append((time.perf_counter(), len(spans)))
            return step(*a, **k)
        return timed

    loop.make_train_step = make_timed
    return record


def rank_main(job: str, rank: int, world: int, port: str, out: Path,
              backend: str, fault: str = "", steps: int = MULTI_STEPS,
              launch: str = "flags") -> int:
    """One rank of the multi-GPU and multi-card phases: ``train`` runs
    ``cli.train_main`` for ``steps`` steps with the coordinator flags, or
    under torchrun's variables (``launch`` "torchrun"), with ``fault``
    planted first if one is named; ``train_sharded`` then takes one step
    of ``make_sharded_train_step`` (``pmean_step=True``) from its state;
    ``downscale`` runs the flagship ``api.downscale`` on a mesh, one
    member and an ensemble of 2, ``downscale_cards`` also one of MEMBERS.
    Gloo ranks share ``cuda:0``; NCCL ranks take a card each.  Each writes
    ``report<rank>.json`` and its results into ``out``."""
    import torch
    import torch.distributed as dist

    from windtpu_torch.core.mesh import all_reduce
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.ops.layer_norm import layer_norm
    from windtpu_torch.train.wgan_gp import critic_graph

    report = {"rank": rank}
    if fault:
        plant_fault(fault)
    device = "cuda:0" if backend == "gloo" else None
    spans, inner_all_reduce = time_all_reduces()
    if job in ("train", "train_sharded"):
        from windtpu_torch import cli
        from windtpu_torch.weights import export_train_state

        steps_run = time_train_steps(spans)
        flags = ([] if launch == "torchrun" else [
            "--coordinator-address", f"localhost:{port}", "--num-processes",
            str(world), "--process-id", str(rank)])
        if device:
            flags += ["--device", device]
        t0 = time.perf_counter()
        state = cli.train_main(TRAIN_ENTRY_ARGV + [
            "--steps", str(steps), "--checkpoint-dir",
            str(out / f"ck{rank}"), "--backend", backend] + flags)
        torch.cuda.synchronize()
        end = time.perf_counter()
        ms = [a.elapsed_time(b) for a, b, *_ in spans]
        starts = steps_run["starts"]
        bounds = [i for _, i in starts] + [len(spans)]
        replayed = replay_all_reduces(
            [call[2:] for call in spans[bounds[-2]:]], inner_all_reduce,
            state.device)
        report.update(
            seconds=end - t0, steps_seconds=end - starts[0][0],
            device=str(state.device), backend=dist.get_backend(),
            k1=convlstm_seq.launches, k2=spatial_ks.launches, steps=steps,
            ln=layer_norm.launches, replays=critic_graph.replays,
            peak_mib=torch.cuda.max_memory_allocated() / 2**20,
            all_reduce_bytes_per_step=all_reduce.bytes / steps,
            all_reduce_calls=len(spans), all_reduce_ms=sum(ms),
            step_all_reduce_calls=[b - a for a, b in zip(bounds,
                                                          bounds[1:])],
            step_all_reduce_ms=[sum(ms[a:b]) for a, b in zip(bounds,
                                                              bounds[1:])],
            replayed_all_reduce_ms=replayed)
        np.savez(out / f"state{rank}.npz", **export_train_state(state))
        if job == "train_sharded":
            from windtpu_torch.core.mesh import make_mesh, shard_batch
            from windtpu_torch.parallel import make_sharded_train_step

            cfg = steps_run["cfg"]
            mesh = make_mesh({"data": world})
            m, b = cfg.model, cfg.train.batch_size
            rng = np.random.default_rng(5)
            shape = (b, m.sequence_length, m.image_size, m.image_size)
            lr, hr = shard_batch(mesh, (
                rng.standard_normal(shape + (m.in_channels,), np.float32),
                rng.standard_normal(shape + (m.out_channels,), np.float32)))
            step = make_sharded_train_step(cfg, mesh)
            state, _ = step(state, torch.from_numpy(lr).to(state.device),
                            torch.from_numpy(hr).to(state.device),
                            torch.Generator(state.device).manual_seed(11))
            torch.cuda.synchronize()
            np.savez(out / f"sharded{rank}.npz",
                     **export_train_state(state))
    else:
        from windtpu_torch import api
        from windtpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(f"localhost:{port}", world, rank,
                               backend=backend, device=device)
        era5, raster = era5_and_dem(21, 42, 24, seed=0)
        network = api.get_network()
        api.downscale(era5, raster, network=network)  # warm-up
        runs = [("tile", 1), ("ensemble", 2)]
        if job == "downscale_cards":
            runs = [("tile", 1), ("ensemble2", 2),
                    (f"ensemble{MEMBERS}", MEMBERS)]
            # Each mesh's first call also starts its NCCL communicators.
            for _, members in runs[1:]:
                api.downscale(era5, raster, network=network,
                              ensemble_members=members)
            # Members whose patch groups split over a data axis, one at a
            # time on the same mesh: the same sums in the same order.
            for _, members in runs[1:]:
                mesh = api.inference_mesh(members)
                if mesh.axis_size("data") == 1:
                    continue
                for s in api.member_seeds(0, members):
                    res = api.downscale(era5, raster, network=network,
                                        seed=s, mesh=mesh)
                    np.savez(out / f"member{s}_{rank}.npz",
                             u10=res["u10"].values, v10=res["v10"].values)
        for name, members in runs:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            convlstm_seq.launches = all_reduce.bytes = 0
            t0 = time.perf_counter()
            res = api.downscale(era5, raster, network=network, seed=0,
                                ensemble_members=members)
            torch.cuda.synchronize()
            report[name] = dict(
                seconds=time.perf_counter() - t0, k1=convlstm_seq.launches,
                peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                all_reduce_bytes=all_reduce.bytes,
                info=api.last_run_info(), device=str(network.device))
            np.savez(out / f"{name}{rank}.npz", u10=res["u10"].values,
                     v10=res["v10"].values)
    (out / f"report{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def state_error(got: dict, want: dict, start: dict) -> dict:
    """The error between two flat train states for each part of the state
    (g_params, g_batch_stats, g_opt/mu, ...), relative to that part's
    movement in the run that took ``start`` to ``want``: ||got - want|| /
    ||want - start||, L2 over all the part's tensors (a part that did not
    move must be equal).  Over a whole part, so that a tensor whose
    gradient is rounding noise (a bias in front of a LayerNorm), which
    Adam still moves by the learning rate, does not stand for it.  Returns
    {part: error} with the largest under "all"."""
    if sorted(got) != sorted(want):
        fail("the two train states have different keys")
    diff, moved = {}, {}
    for k, w in want.items():
        w = w.astype(np.float64)
        part = "/".join(k.split("/")[:2 if k.startswith(("g_opt", "d_opt"))
                                     else 1])
        diff[part] = diff.get(part, 0.0) + float(np.sum((got[k] - w) ** 2))
        moved[part] = moved.get(part, 0.0) + float(np.sum((w - start[k])
                                                          ** 2))
    worst = {p: (np.sqrt(diff[p] / moved[p]) if moved[p] else
                 (0.0 if diff[p] == 0.0 else float("inf")))
             for p in diff}
    worst["all"] = max(worst.values())
    return worst


def describe(worst: dict) -> str:
    parts = ", ".join(f"{p} {e:.3e}" for p, e in sorted(worst.items())
                      if p != "all")
    return f"{worst['all']:.3e} ({parts})"


def multi_gpu_phase() -> dict:
    from windtpu_torch import api, cli
    from windtpu_torch.weights import export_train_state

    work = ROOT / "build" / "chip_smoke_multi_gpu"
    shutil.rmtree(work, ignore_errors=True)
    print("two ranks share card 0 under gloo (NCCL refuses two ranks on "
          "one card): these runs test correctness, not speed; the "
          "multi-card path runs NCCL across cards")

    def single(steps: int, name: str) -> dict:
        return export_train_state(cli.train_main(TRAIN_ENTRY_ARGV + [
            "--steps", str(steps), "--checkpoint-dir", str(work / name)]))

    start = single(0, "start")
    plain, again = single(MULTI_STEPS, "plain"), single(MULTI_STEPS, "again")
    print(f"train_main, one process, run 2 vs run 1 (the card's run-to-run "
          f"spread), relative to each part's movement: "
          f"{describe(state_error(again, plain, start))}")
    counts = {"convlstm_seq": 0, "spatial_ks": 0, "layer_norm": 0}
    seq, model = 6, None
    problems = []
    runs = ([("nccl", 1, "nccl", ""), ("gloo_train", 2, "gloo", "")]
            + [(f"fault{i}", 2, "gloo", f)
               for i, f in enumerate(MULTI_FAULTS)])
    for name, world, backend, fault in runs:
        reports = run_ranks("train", world, backend, work / name, fault)
        states = [dict(np.load(work / name / f"state{r}.npz"))
                  for r in range(world)]
        worst = state_error(states[0], plain, start)
        if fault:
            caught = worst["all"] > MULTI_TRAIN_TOL
            print(f"train_main {backend} at {world} ranks with a planted "
                  f"fault, {fault}: vs one process {describe(worst)} (tol "
                  f"{MULTI_TRAIN_TOL:.0e}): "
                  f"{'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                problems.append(f"the limit misses the fault {fault}")
            continue
        for rep in reports:
            print(f"train_main {backend} rank {rep['rank']} of {world} on "
                  f"{rep['device']} ({rep['backend']}), batch 16 / {world}"
                  f" per rank, {MULTI_STEPS} steps: {rep['seconds']:.3f} s "
                  f"(process set-up included), peak memory allocated "
                  f"{rep['peak_mib']:.0f} MiB, convlstm_seq {rep['k1']}, "
                  f"spatial_ks {rep['k2']}, layer_norm {rep['ln']}, "
                  f"all-reduce "
                  f"{rep['all_reduce_bytes_per_step'] / 2**20:.3f} MiB per "
                  f"step")
            want = k1_launches(seq, MULTI_STEPS, rep["replays"])
            want_ln = ln_launches(model, MULTI_STEPS, rep["replays"])
            if (rep["k1"] != want or rep["k2"] != MULTI_STEPS
                    or rep["ln"] != want_ln):
                problems.append(
                    f"train_main {backend} rank {rep['rank']}: convlstm_seq "
                    f"{rep['k1']} (expected {want}), "
                    f"spatial_ks {rep['k2']} (expected {MULTI_STEPS}), "
                    f"layer_norm {rep['ln']} (expected {want_ln})")
            counts["convlstm_seq"] += rep["k1"]
            counts["spatial_ks"] += rep["k2"]
            counts["layer_norm"] += rep["ln"]
        for r in range(1, world):
            differ = [k for k in plain
                      if not np.array_equal(states[r][k], states[0][k])]
            print(f"train_main {backend}: rank {r} vs rank 0: "
                  f"{len(differ)} of {len(plain)} tensors differ (tol 0)")
            if differ:
                problems.append(f"train_main {backend}: the ranks' states "
                                f"differ at {differ[:3]}")
        ok = worst["all"] <= MULTI_TRAIN_TOL
        print(f"train_main {backend} at {world} rank(s) vs one process, "
              f"relative to each part's movement: {describe(worst)} (tol "
              f"{MULTI_TRAIN_TOL:.0e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            problems.append(f"train_main {backend} at {world} rank(s) "
                            f"disagrees with the single process")
    if problems:
        fail("; ".join(problems))

    reports = run_ranks("downscale", 2, "gloo", work / "downscale")
    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    network = api.get_network()
    want = {"tile": [api.downscale(era5, raster, network=network, seed=0)],
            "ensemble": [api.downscale(era5, raster, network=network,
                                       seed=s)
                         for s in api.member_seeds(0, 2)]}
    modes = {"tile": ("tile", {"data": 2}), "ensemble": ("ensemble",
                                                         {"ensemble": 2})}
    for name in ("tile", "ensemble"):
        for rep in reports:
            r = rep[name]
            print(f"downscale {name} rank {rep['rank']} of 2 on "
                  f"{r['device']} (gloo): {r['seconds']:.3f} s, peak device "
                  f"memory above the weights {r['peak_mib']:.1f} MiB, "
                  f"convlstm_seq {r['k1']}, all-reduce "
                  f"{r['all_reduce_bytes'] / 2**20:.1f} MiB, {r['info']}")
            mode, axes = modes[name]
            if (r["info"]["mode"] != mode or r["info"]["mesh_axes"] != axes
                    or r["k1"] != (2 if name == "tile" else 4) * 24):
                fail(f"downscale {name} rank {rep['rank']} ran "
                     f"{r['info']} with {r['k1']} convlstm_seq launches")
            counts["convlstm_seq"] += r["k1"]
        got = [dict(np.load(work / "downscale" / f"{name}{r}.npz"))
               for r in range(2)]
        for var in ("u10", "v10"):
            if not np.array_equal(got[0][var], got[1][var], equal_nan=True):
                fail(f"downscale {name}: the ranks' {var} differ")
            for m, w in enumerate(want[name]):
                g = got[0][var] if name == "tile" else got[0][var][m]
                w = w[var].values
                if name == "tile":
                    compare(f"bf16 downscale {var}, 2 ranks tile-parallel "
                            f"vs one device", g, w,
                            STREAM_BF16_REL * float(np.nanmax(np.abs(w))),
                            mean_tol=STREAM_BF16_MEAN_TOL)
                else:
                    compare(f"bf16 downscale {var}, member {m} over the "
                            f"ensemble axis vs its one-member run", g, w,
                            MEMBER_TOL)
    shutil.rmtree(work, ignore_errors=True)
    return counts


def multi_card_phase() -> dict:
    """train_main and the flagship downscale over NCCL, one rank per card,
    against single-process runs on card 0; fails on a machine with one
    card (the full run skips the phase there with a line saying so)."""
    import torch

    from windtpu_torch import api, cli
    from windtpu_torch.weights import export_train_state

    cards = torch.cuda.device_count()
    if cards < 2:
        fail(f"the multi-card path needs 2 or more cards; this machine has "
             f"{cards}")
    world = MULTI_CARDS if cards >= MULTI_CARDS else 2
    work = ROOT / "build" / "chip_smoke_multi_card"
    shutil.rmtree(work, ignore_errors=True)
    print(f"{world} ranks over NCCL, one per card, on {cards} cards: "
          f"{[torch.cuda.get_device_name(i) for i in range(cards)]}")

    def single(steps: int, name: str) -> dict:
        return export_train_state(cli.train_main(TRAIN_ENTRY_ARGV + [
            "--steps", str(steps), "--checkpoint-dir", str(work / name)]))

    short, long = TRAIN_MAIN_STEPS
    start, plain = single(0, "start"), single(short, "plain")
    counts = {"convlstm_seq": 0, "spatial_ks": 0, "layer_norm": 0}
    seq, model, problems = 6, None, []
    # (name, ranks, steps, fault); the first W-rank run starts as torchrun
    # starts ranks and also takes a make_sharded_train_step step.
    runs = [(f"nccl{w}x{n}", w, n, "") for w in sorted({1, 2, world})
            for n in (short, long)]
    runs += [(f"fault{i}", world, short, f)
             for i, f in enumerate(MULTI_FAULTS)]
    timing = {}
    for name, w, steps, fault in runs:
        main = (w, steps, fault) == (world, short, "")
        reports = run_ranks("train_sharded" if main else "train", w, "nccl",
                            work / name, fault, steps=steps, torchrun=main)
        states = [dict(np.load(work / name / f"state{r}.npz"))
                  for r in range(w)]
        if fault:
            worst = state_error(states[0], plain, start)
            caught = worst["all"] > MULTI_TRAIN_TOL
            print(f"train_main nccl at {w} ranks with a planted fault, "
                  f"{fault}: vs one process {describe(worst)} (tol "
                  f"{MULTI_TRAIN_TOL:.0e}): "
                  f"{'caught' if caught else 'NOT CAUGHT'}")
            if not caught:
                problems.append(f"the limit misses the fault {fault} at "
                                f"{w} NCCL ranks")
            continue
        timing[w, steps] = reports
        for rep in reports:
            print(f"train_main nccl rank {rep['rank']} of {w} "
                  f"({'torchrun variables' if main else 'coordinator flags'}"
                  f") on {rep['device']} ({rep['backend']}), batch 16 / {w} "
                  f"per rank, {steps} steps: {rep['seconds']:.3f} s (process "
                  f"set-up included), peak memory allocated "
                  f"{rep['peak_mib']:.0f} MiB, convlstm_seq {rep['k1']}, "
                  f"spatial_ks {rep['k2']}, all-reduce "
                  f"{rep['all_reduce_bytes_per_step'] / 2**20:.3f} MiB per "
                  f"step in {rep['all_reduce_calls']} calls, "
                  f"{rep['all_reduce_ms']:.3f} ms in them (CUDA events)")
            if (rep["device"] != f"cuda:{rep['rank']}"
                    or rep["backend"] != "nccl"):
                problems.append(f"rank {rep['rank']} of {w} ran on "
                                f"{rep['device']} ({rep['backend']})")
            want = k1_launches(seq, steps, rep["replays"])
            want_ln = ln_launches(model, steps, rep["replays"])
            if (rep["k1"] != want or rep["k2"] != steps
                    or rep["ln"] != want_ln):
                problems.append(
                    f"train_main nccl rank {rep['rank']} of {w}: "
                    f"convlstm_seq {rep['k1']} (expected {want}), "
                    f"spatial_ks {rep['k2']} (expected {steps}), "
                    f"layer_norm {rep['ln']} (expected {want_ln})")
            counts["convlstm_seq"] += rep["k1"]
            counts["spatial_ks"] += rep["k2"]
            counts["layer_norm"] += rep["ln"]
        finals = [states] + ([[dict(np.load(work / name / f"sharded{r}.npz"))
                               for r in range(w)]] if main else [])
        for what, ranks in zip(("train_main", "make_sharded_train_step"),
                               finals):
            for r in range(1, w):
                differ = [k for k in ranks[0]
                          if not np.array_equal(ranks[r][k], ranks[0][k])]
                print(f"{what} nccl at {w} ranks, {steps} steps: rank {r} "
                      f"vs rank 0: {len(differ)} of {len(ranks[0])} tensors "
                      f"differ (tol 0)")
                if differ:
                    problems.append(f"{what} nccl at {w} ranks: the ranks' "
                                    f"states differ at {differ[:3]}")
        if steps == short:
            worst = state_error(states[0], plain, start)
            ok = worst["all"] <= MULTI_TRAIN_TOL
            print(f"train_main nccl at {w} rank(s) vs one process, relative "
                  f"to each part's movement: {describe(worst)} (tol "
                  f"{MULTI_TRAIN_TOL:.0e}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                problems.append(f"train_main nccl at {w} rank(s) disagrees "
                                f"with the single process")
    if problems:
        fail("; ".join(problems))
    smi = device_line()
    for w in sorted({1, 2, world}):
        a, b = timing[w, short], timing[w, long]

        def slowest(key, reports):
            return max(r[key] for r in reports)

        per_step = ((slowest("steps_seconds", b) - slowest("steps_seconds", a))
                    / (long - short))
        whole = (slowest("seconds", b) - slowest("seconds", a)) / (long - short)
        # Steps 2 on of the longer run: step 1 also starts cuDNN's and
        # NCCL's plans.
        nccl_ms = max(float(np.mean(r["step_all_reduce_ms"][1:])) for r in b)
        calls = b[0]["step_all_reduce_calls"][1:]
        print(f"train_main at {w} NCCL rank(s), global batch 16: "
              f"{per_step:.4f} s per step (the difference of the {long}- and "
              f"{short}-step walls from the first step on, over "
              f"{long - short} steps; from the process's start "
              f"{whole:.4f}), all-reduce "
              f"{b[0]['all_reduce_bytes_per_step'] / 2**20:.3f} MiB per "
              f"step per rank in {calls} calls per step (steps 2 to "
              f"{long}), {nccl_ms:.3f} ms per step in them (the slowest "
              f"rank's mean over steps 2 to {long}; per step "
              f"{[round(x, 3) for x in max(b, key=lambda r: r['all_reduce_ms'])['step_all_reduce_ms']]}"
              f"), {slowest('replayed_all_reduce_ms', b):.3f} ms for the "
              f"last step's all-reduces replayed back to back (slowest "
              f"rank), peak memory per rank {slowest('peak_mib', a):.0f} "
              f"MiB ({smi})")

    reports = run_ranks("downscale_cards", world, "nccl",
                        work / "downscale")
    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    network = api.get_network()
    api.downscale(era5, raster, network=network, seed=0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tile = api.downscale(era5, raster, network=network, seed=0)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    one = {}
    for m in (2, MEMBERS):
        for s in api.member_seeds(0, m):
            if s not in one:
                one[s] = api.downscale(era5, raster, network=network, seed=s)
    print(f"downscale on one card (card 0): {single_s:.3f} s")
    for name, members in (("tile", 1), ("ensemble2", 2),
                          (f"ensemble{MEMBERS}", MEMBERS)):
        axes = api.inference_mesh_axes(members, world)
        mode = (("ensemble" if members > 1 else "tile")
                + ("+tile" if members > 1 and axes.get("data", 1) > 1
                   else ""))
        k1 = 24 * -(-4 // axes.get("data", 1))   # 4 groups of 16 patches
        for rep in reports:
            r = rep[name]
            print(f"downscale {name} rank {rep['rank']} of {world} on "
                  f"{r['device']} (nccl): {r['seconds']:.3f} s (one card "
                  f"{single_s:.3f} s), peak "
                  f"device memory above the weights {r['peak_mib']:.1f} "
                  f"MiB, convlstm_seq {r['k1']}, all-reduce "
                  f"{r['all_reduce_bytes'] / 2**20:.1f} MiB, {r['info']}")
            if (r["info"]["mode"] != mode or r["info"]["mesh_axes"] != axes
                    or r["info"]["ensemble_sharded"] != (members > 1)
                    or r["device"] != f"cuda:{rep['rank']}"
                    or r["k1"] != k1):
                fail(f"downscale {name} rank {rep['rank']} ran {r['info']} "
                     f"on {r['device']} with {r['k1']} convlstm_seq "
                     f"launches (expected {mode} on {axes}, {k1})")
            counts["convlstm_seq"] += r["k1"]
        got = [dict(np.load(work / "downscale" / f"{name}{r}.npz"))
               for r in range(world)]
        for var in ("u10", "v10"):
            for r in range(1, world):
                if not np.array_equal(got[r][var], got[0][var],
                                      equal_nan=True):
                    fail(f"downscale {name}: rank {r}'s {var} differs from "
                         f"rank 0's")
            if members == 1:
                w = tile[var].values
                compare(f"bf16 downscale {var}, {world} ranks tile-parallel "
                        f"vs one card", got[0][var], w,
                        STREAM_BF16_REL * float(np.nanmax(np.abs(w))),
                        mean_tol=STREAM_BF16_MEAN_TOL)
                continue
            for m, s in enumerate(api.member_seeds(0, members)):
                w = one[s][var].values
                if axes.get("data", 1) == 1:
                    compare(f"bf16 downscale {var}, member {m} of {members} "
                            f"on {axes} vs its one-member run on one card",
                            got[0][var][m], w, MEMBER_TOL)
                    continue
                # Split over the data axis, a member sums its statistics
                # and canvas over ranks, as tile-parallel does: exactly its
                # one-member run tile-parallel on that axis, and within the
                # streaming limits of one card.
                tiled = np.load(work / "downscale" / f"member{s}_0.npz")[var]
                compare(f"bf16 downscale {var}, member {m} of {members} on "
                        f"{axes} vs its one-member run over the same data "
                        f"axis", got[0][var][m], tiled, MEMBER_TOL)
                compare(f"bf16 downscale {var}, member {m} of {members} on "
                        f"{axes} vs its one-member run on one card",
                        got[0][var][m], w,
                        STREAM_BF16_REL * float(np.nanmax(np.abs(w))),
                        mean_tol=STREAM_BF16_MEAN_TOL)
    shutil.rmtree(work, ignore_errors=True)
    return counts


def relative_errors(got: dict, want: dict) -> dict:
    """Per key: max |got - want| / max |want| (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        scale = float(np.abs(w).max())
        diff = float(np.abs(g - w).max())
        out[k] = diff / scale if scale > 0 else diff
    return out


def worst(errors: dict) -> str:
    key = max(errors, key=errors.get)
    return f"{errors[key]:.3e} ({key})"


def remat_pass(dtype: str, deterministic: bool, problems: list) -> dict:
    """One train step at the training path's shape in ``dtype`` under each
    of REMAT_RUNS, from one saved state and one set of draws, with cuDNN's
    ``deterministic`` algorithms or its defaults; returns the K1 and K2
    launches of them all, and appends what exceeds a limit to
    ``problems``."""
    import torch

    from windtpu_torch import api
    from windtpu_torch.network import WindDownscalingGAN
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.ops.ks import spatial_ks
    from windtpu_torch.ops.layer_norm import layer_norm
    from windtpu_torch.train.wgan_gp import (critic_graph, draw_step_noise,
                                             make_train_step)
    from windtpu_torch.weights import export_train_state, load_train_state

    # Batch 2, 96 px, T=24, F=128/16, n_critic=3, metrics and spatial KS.
    base = api.flagship_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, compute_dtype=dtype),
        train=dataclasses.replace(base.train, batch_size=2,
                                  compute_metrics=True,
                                  compute_spatial_ks=True))
    state = WindDownscalingGAN(cfg).load_weights(
        api.BUNDLED_GENERATOR).state
    warm, batch = train_batches(cfg, 2, seed=0)
    rng = torch.Generator(device="cuda").manual_seed(5)
    # Warm-up, through the checkpoint too: its first call in a process
    # takes seconds of set-up.
    make_train_step(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, remat=True, remat_gp=True)))(state, *warm, rng)
    saved = export_train_state(state)
    draws = draw_step_noise(cfg, batch[0].shape, batch[1].shape[-1], rng,
                            "cuda")
    seq = cfg.model.sequence_length
    runs, total = {}, {"convlstm_seq": 0, "spatial_ks": 0, "layer_norm": 0}
    # The peak of each part of the step: every optimizer update ends one
    # (the n_critic critic updates, then the generator's); the metric
    # recompute follows.
    parts = []

    def marked(update):
        def step(grads):
            parts.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            update(grads)
        return step

    for opt in (state.d_opt, state.g_opt):
        opt.step = marked(opt.step)
    label = f"{dtype}, {'deterministic' if deterministic else 'default'} cuDNN"
    torch.backends.cudnn.deterministic = deterministic
    for name, remat, remat_gp in REMAT_RUNS:
        mode = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, remat=remat, remat_gp=remat_gp))
        step = make_train_step(mode)
        load_train_state(state, saved)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        convlstm_seq.launches = spatial_ks.launches = layer_norm.launches = 0
        replays = critic_graph.replays
        parts.clear()
        t0 = time.perf_counter()
        _, metrics = step(state, *batch, draws=draws)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        parts.append(torch.cuda.max_memory_allocated())
        mib = [b / 2**20 for b in parts]
        k1, k2, n_ln = (convlstm_seq.launches, spatial_ks.launches,
                        layer_norm.launches)
        total["convlstm_seq"] += k1
        total["spatial_ks"] += k2
        total["layer_norm"] += n_ln
        written = {k: v for k, v in export_train_state(state).items()
                   if k.split("/")[0] in ("g_batch_stats", "g_spectral",
                                          "d_spectral")}
        runs[name] = (metrics, written)
        # remat=True runs the update's forward again in the backward,
        # "save_scans" keeps its ConvLSTM.  A run with the key of an
        # earlier one ("False again") replays its graph.
        want_k1 = k1_launches(seq, 1, critic_graph.replays - replays,
                              extra=int(remat is True))
        want_ln = ln_launches(cfg.model, 1, critic_graph.replays - replays,
                              remat, remat_gp)
        if k1 != want_k1 or k2 != 1 or n_ln != want_ln:
            fail(f"remat {name}: convlstm_seq launched {k1} times "
                 f"(expected {want_k1}), spatial_ks {k2} (expected 1), "
                 f"layer_norm {n_ln} (expected {want_ln})")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            fail(f"remat {name}: metrics {bad} are not finite")
        base_metrics, base_written = runs["False"]
        m_err = relative_errors(metrics, base_metrics)
        s_err = relative_errors(written, base_written)
        # A replayed graph of the critic updates calls no optimizer step
        # of the critic's: its peak is the generator update's then.
        critic = f"{max(mib[:-2]):.1f}" if mib[:-2] else "replayed"
        print(f"remat {name} [{label}]: {seconds:.3f} s per step, peak "
              f"memory allocated {max(mib):.1f} MiB (critic updates "
              f"{critic}, generator update {mib[-2]:.1f}, "
              f"metrics {mib[-1]:.1f}), convlstm_seq launches {k1}, "
              f"spatial_ks {k2}, layer_norm {n_ln}; against remat False: state written in the "
              f"forwards {worst(s_err)}, metrics {worst(m_err)}; relative "
              f"metric differences above 1e-6: "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
                  m_err.items(), key=lambda kv: -kv[1]) if v > 1e-6))
        if deterministic and max(m_err.values()) > REMAT_METRIC_TOL:
            problems.append(f"remat {name} [{label}]: metrics off by "
                            f"{worst(m_err)} (tol {REMAT_METRIC_TOL:.0e})")
        if max(s_err.values()) > REMAT_STATE_TOL:
            problems.append(f"remat {name} [{label}]: the state written in "
                            f"the forwards is off by {worst(s_err)} (tol "
                            f"{REMAT_STATE_TOL:.0e})")
    torch.backends.cudnn.deterministic = False
    print(f"remat False's metrics [{label}]: "
          + ", ".join(f"{k} {v:.6g}" for k, v in runs["False"][0].items()))
    return total


def a13_path_phase() -> dict:
    """The remat modes at the flagship training shape and in f32 against
    the CPU, the texture gate's device half at the flagship inference
    domain, and profile_region around a flagship downscale."""
    import tempfile

    import torch

    from windtpu_torch import api
    from windtpu_torch.core.config import GANConfig, ModelConfig, TrainConfig
    from windtpu_torch.models import texture_gate as tg
    from windtpu_torch.ops.convlstm import convlstm_seq
    from windtpu_torch.utils import profile_region

    counts = {"convlstm_seq": 0, "spatial_ks": 0, "layer_norm": 0}
    problems = []
    for dtype, deterministic in (("bfloat16", False), ("float32", True)):
        for k, n in remat_pass(dtype, deterministic, problems).items():
            counts[k] += n
    if problems:
        fail("; ".join(problems))

    # Remat in f32 at a small shape: the card against the CPU.
    small = GANConfig(
        model=ModelConfig(image_size=24, sequence_length=4,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=2, compute_spatial_ks=True,
                          remat="save_scans", remat_gp=True))
    train_step_pair(small, {"cuda": None, "cpu": None},
                    name="remat save_scans+remat_gp reference")

    # The texture gate's device half at the flagship inference domain.
    params = tg.load_gate_npz(api.BUNDLED_GATE)
    era5, raster = era5_and_dem(21, 42, 24, seed=0)
    field = merged_field(era5, raster)[None]           # (1, 24, 546, 756, 3)
    t0 = time.perf_counter()
    host = tg.predict_log_energy_np(params, field)
    host_ms = 1e3 * (time.perf_counter() - t0)
    on_card = torch.from_numpy(field).cuda()
    card = tg.predict_log_energy(params, on_card).cpu().numpy()
    card_ms = cuda_ms(lambda: tg.predict_log_energy(params, on_card), 5)
    err = float(np.abs(card - host).max())
    print(f"gate predict_log_energy {field.shape} f32: card {card_ms:.3f} "
          f"ms (field on the card), host predict_log_energy_np "
          f"{host_ms:.1f} ms; max |log energy difference| {err:.3e} (tol "
          f"{GATE_TOL:.0e}), log energies {np.round(host.ravel(), 4)}")
    if not np.isfinite(card).all() or err > GATE_TOL:
        fail("the card's gate energy prediction disagrees with the host's")
    rng = np.random.default_rng(3)                 # a (2, 24, 96, 96) batch
    low = rng.standard_normal((2, 24, 96, 96, 3), dtype=np.float32)
    fake = 4.0 * rng.standard_normal((2, 24, 96, 96, 2), dtype=np.float32)
    low_c, fake_c = torch.from_numpy(low).cuda(), torch.from_numpy(fake).cuda()
    gated = tg.apply_gate(params, low_c, fake_c)
    compare("gate apply_gate (2, 24, 96, 96, 2), card vs CPU",
            gated.cpu().numpy(),
            tg.apply_gate(params, torch.from_numpy(low),
                          torch.from_numpy(fake)).numpy(),
            atol=GATE_TOL, rtol=GATE_TOL)
    split = tg.apply_gate_targeted(
        torch.from_numpy(np.exp(tg.predict_log_energy_np(params, low))).cuda(),
        torch.tensor(params["floor"]).cuda(), fake_c)
    compare("gate apply_gate vs the split path (host prediction, "
            "apply_gate_targeted), card", gated.cpu().numpy(),
            split.cpu().numpy(), atol=GATE_TOL, rtol=GATE_TOL)

    # profile_region around one flagship downscale.
    network = api.get_network()
    api.downscale(era5, raster, network=network)              # warm-up
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as trace_dir:
        convlstm_seq.launches = 0
        with profile_region(trace_dir):
            api.downscale(era5, raster, network=network)
        counts["convlstm_seq"] += convlstm_seq.launches
        path = Path(trace_dir) / "trace.json"
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "convlstm_step" in e.get("name", "")]
    print(f"profile_region around a flagship downscale: trace.json "
          f"{size / 2**20:.1f} MiB, {len(events)} events, {len(k1)} K1 "
          f"kernel events ({k1[0]['name'][:60] if k1 else None}), "
          f"{convlstm_seq.launches} K1 launches")
    if len(k1) != convlstm_seq.launches or not k1:
        fail("the trace does not hold one K1 kernel event per launch")
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


def profile_device(fn) -> list:
    """Device time by kernel over one more call, and the device's busy
    share of the call's wall time; returns (kernel, ms, count) rows, none
    where the profiler recorded no device time."""
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
        return rows
    print(f"profile: wall {wall * 1e3:.1f} ms, device kernels "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {key[:90]}")
    return rows


PHASES = {
    "build": build_all,
    "kernel convlstm_seq": convlstm_kernel_phase,
    "kernel spatial_ks": ks_kernel_phase,
    "kernel layer_norm": layer_norm_kernel_phase,
    "reference": reference_phase,
    "downscale path": downscale_path_phase,
    "training reference": training_reference_phase,
    "training path": training_path_phase,
    "streaming path": streaming_path_phase,
    "train entry": train_entry_phase,
    "prepare path": prepare_path_phase,
    "multi-GPU path": multi_gpu_phase,
    "multi-card path": multi_card_phase,
    "A13 path": a13_path_phase,
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
    if sys.argv[1:2] == ["--rank"]:   # a rank of a multi-process phase
        job, rank, world, port, out, backend, fault, steps, launch = \
            sys.argv[2:11]
        return rank_main(job, int(rank), int(world), port, Path(out),
                         backend, fault, int(steps), launch)

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
            if (fn is multi_card_phase and not chosen
                    and torch.cuda.device_count() < 2):
                print(f"not run: the multi-card path needs 2 or more cards; "
                      f"this machine has {torch.cuda.device_count()}")
                continue
            results[name] = fn()
    if chosen:
        print(f"ran only {chosen}: no result line")
        return 0

    stats = {"convlstm_seq": results["kernel convlstm_seq"],
             "spatial_ks": results["kernel spatial_ks"],
             "layer_norm": results["kernel layer_norm"]}
    streamed = results["streaming path"]
    paths = {"downscale": results["downscale path"],
             "train": results["training path"],
             "streaming": {"convlstm_seq": streamed["streaming"]},
             "ensemble": {"convlstm_seq": streamed["ensemble"]},
             "train_main": results["train entry"],
             "prepare": results["prepare path"],
             "multi_gpu": results["multi-GPU path"],
             "a13": results["A13 path"]}
    if "multi-card path" in results:
        paths["multi_card"] = results["multi-card path"]
    kernels = []
    for k in KERNELS:
        by_path = {path: counts.get(k["name"], 0)
                   for path, counts in paths.items()}
        for path in ("train", "train_main", "multi_gpu", "a13",
                     "multi_card"):
            if by_path.get(path, 1) == 0:
                fail(f"{k['name']} was not launched on the {path} path")
        kernels.append({**k, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **stats[k["name"]]})
    for path in ("downscale", "streaming", "ensemble", "prepare"):
        if paths[path]["convlstm_seq"] == 0:
            fail(f"convlstm_seq was not launched on the {path} path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
