"""Downscale driver: a user downscaling many days over one region.

Set-up makes ``days`` ERA5 days and one DEM from the seed, loads the
network as ``api.get_network`` does (the bundled generator and texture
gate, read in place) and downscales the first day once.  The window then
calls ``windtpu_torch.api.downscale`` on the days in turn, each with its
own noise seed, and waits for each result (the in-memory Dataset; no file
is written).  A sample of the days, drawn from the seed, is kept and,
after the window, worked out again by the plain reference in float32.

Trace runs time the engine (``api.downscale_field``, ending in a
synchronise) and record K1's calls; the gate is read from the program's
own ``predict.gate`` span.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench import compare, inputs
from portbench import harness as H
from portbench.reference import downscale as RD
from portbench.reference import params as RP
from portbench.reference.layers import FP32, Precision

# The configuration's ``model_flops`` key of one unit of the window.
FLOPS_UNIT = "downscale_day"
KEEP = 4          # sampled days kept for the comparison, at most


def datasets(era5: dict, topo: dict):
    """The port's Dataset objects for one day and the DEM."""
    from windtpu_torch.io.dataset import DataArray, Dataset

    dims = ("time", "latitude", "longitude")
    day = Dataset(
        {"u10": DataArray(dims, era5["u10"]),
         "v10": DataArray(dims, era5["v10"])},
        {"time": DataArray(("time",), era5["time"]),
         "latitude": DataArray(("latitude",), era5["latitude"]),
         "longitude": DataArray(("longitude",), era5["longitude"])})
    raster = Dataset(
        {"band_data": DataArray(("band", "y", "x"), topo["band"][None])},
        {"band": DataArray(("band",), np.array([1])),
         "y": DataArray(("y",), topo["y"]),
         "x": DataArray(("x",), topo["x"])})
    return day, raster


def network(cell: H.Cell, seed: int, device):
    """The network the cell runs and the reference's copy of its
    weights: the bundled ones (``api.get_network``), or weights from the
    seed where the configuration says so."""
    from windtpu_torch import api

    m = cell.config["model"]
    if cell.config["weights"] == "bundled":
        net = api.get_network(device=device)
        with np.load(api.BUNDLED_GENERATOR) as z:
            flat = {k.split("/", 1)[1].replace("/", "."): z[k]
                    for k in z.files}
    else:
        import dataclasses

        from windtpu_torch.network import WindDownscalingGAN
        from windtpu_torch.models.texture_gate import load_gate_npz

        cfg = api.flagship_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **m))
        net = WindDownscalingGAN(cfg, device=device)
        shapes, state = RP.generator(m["in_channels"], m["noise_channels"],
                                     m["out_channels"],
                                     m["generator_features"])
        p, s = inputs.weights(shapes, state, seed, device)
        net.generator.load_state_dict({**p, **s})
        net.texture_gate = load_gate_npz(api.BUNDLED_GATE)
        flat = {k: v.cpu().numpy() for k, v in {**p, **s}.items()}
    with np.load(api.BUNDLED_GATE) as z:
        gate = {k: np.asarray(z[k]) for k in z.files}
    return net, flat, gate


def reference(cell: H.Cell, flat, gate, days, topo, kept, device,
              prec: Precision = FP32):
    """The reference's prediction of each kept (day index, noise seed)."""
    m, inf = cell.config["model"], cell.config["inference"]
    shapes, state = RP.generator(m["in_channels"], m["noise_channels"],
                                 m["out_channels"], m["generator_features"])
    p = {k: torch.as_tensor(flat[k], device=device) for k in shapes}
    s = {k: torch.as_tensor(flat[k], device=device) for k in state}
    out = []
    with full_f32():
        for day, noise_seed in kept:
            out.append(RD.downscale(
                days[day], topo, p, s, gate, noise_seed, prec, device,
                img=m["image_size"], seq=m["sequence_length"],
                noise_channels=m["noise_channels"],
                noise_std=inf["noise_std"], group=inf["group_size"],
                overlap=inf["overlap_factor"]))
    return out


@contextlib.contextmanager
def full_f32():
    """Products in full float32: no TF32 in cuDNN or cuBLAS."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run(cell: H.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> H.Outcome:
    import windtpu_torch.api as api
    import windtpu_torch.models.generator as gen_mod

    device = torch.device(device or "cuda")
    sync = _sync(device)
    tr = cell.traffic
    dom = cell.config["inference"]["domain"]
    raw = inputs.era5_days(seed, tr["days"], dom["era5_lat"],
                           dom["era5_lon"], dom["hours"])
    topo = inputs.dem(seed, dom["era5_lat"], dom["era5_lon"])
    ds = [datasets(d, topo) for d in raw]
    spans = H.Spans()
    window = H.Window(seconds)
    tracer = H.Tracer(trace, 1, int(cell.spec["trace_units"]), spans, sync)
    every = int(tr["sample_every"])
    offset = seed % every
    kept, outputs = [], []
    with contextlib.ExitStack() as patches:
        if trace:
            patches.enter_context(spans.k1(gen_mod))
            patches.enter_context(spans.wrap(api, "downscale_field",
                                             "engine", sync))
        net, flat, gate = network(cell, seed, device)

        def day(i):
            era5, raster = ds[i % len(ds)]
            res = api.downscale(
                era5, raster, network=net, device=device,
                seed=H.subseed(seed, 9, i),
                ensemble_members=tr["ensemble_members"],
                streaming=tr["streaming"], texture_gate=tr["texture_gate"])
            return np.stack([res["u10"].values, res["v10"].values], -1)

        day(0)                                   # warm-up: builds, plans
        sync()
        setup_s = time.perf_counter() - t_start
        for k in spans.times.values():
            k.clear()
        window.begin()
        i = 0
        last = None
        while not window.closed:
            tracer.before_unit(i)
            out = day(i)
            window.end_unit()
            tracer.after_unit(i)
            if (i + offset) % every == 0 and len(kept) < KEEP:
                kept.append((i % len(ds), H.subseed(seed, 9, i)))
                outputs.append(out)
            last = (i, out)
            i += 1
        tracer.stop()
    if not kept:
        i, out = last
        kept.append((i % len(ds), H.subseed(seed, 9, i)))
        outputs.append(out)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del net
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs = reference(cell, flat, gate, raw, topo, kept, device)
    numbers = compare.downscale(list(zip(outputs, refs)))
    print(f"# downscale: {window.units} days in {window.elapsed:.3f} s; "
          f"compared days {[d for d, _ in kept]}", file=sys.stderr)
    run_ = H.Run(cell, window.units, window.durations(), spans, {},
                 tracer.data, tracer.unit_s,
                 H.busy_s(tracer.data) if tracer.data else None)
    return H.Outcome(
        run=run_,
        end_to_end={"downscale_s": window.elapsed / window.units},
        setup_s=setup_s, attempted=window.units, failed=0,
        memory_peak=int(peak),
        checks=H.checks_from(numbers, cell.spec["limits"]))
