"""The control of each cell's ``correct``: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states, and compared with the float32 reference by the same
numbers and limits as a run:

- a bfloat16 configuration: float8 (e4m3) operands in every product, one
  scale per tensor, bfloat16 elsewhere;
- a float32 configuration run with cuDNN's default TF32: bfloat16.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

at the cell's own sizes, on the card: a downscale cell on the days a run
compares (the sampled days of a window of the cell's usual length), a
train cell on its three checked steps.  Prints one JSON line per seed;
the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import compare, inputs
from portbench import harness as H
from portbench.reference.layers import Precision

LOWER = {"bfloat16": Precision(torch.bfloat16, torch.float8_e4m3fn),
         "float32": Precision(torch.bfloat16)}
DAYS_IN_WINDOW = 34      # about a 51 s window of the flagship downscale


def lower(cell: H.Cell) -> Precision:
    return LOWER[cell.config["model"]["compute_dtype"]]


def downscale_numbers(cell: H.Cell, seed: int, device, prec: Precision,
                      days_in_window: int = DAYS_IN_WINDOW):
    from portbench.drivers import downscale as D

    tr = cell.traffic
    dom = cell.config["inference"]["domain"]
    raw = inputs.era5_days(seed, tr["days"], dom["era5_lat"],
                           dom["era5_lon"], dom["hours"])
    topo = inputs.dem(seed, dom["era5_lat"], dom["era5_lon"])
    every = int(tr["sample_every"])
    kept = [(i % len(raw), H.subseed(seed, 9, i))
            for i in range(days_in_window)
            if (i + seed % every) % every == 0][:D.KEEP]
    flat, gate = _downscale_weights(cell, seed, device)
    want = D.reference(cell, flat, gate, raw, topo, kept, device)
    got = D.reference(cell, flat, gate, raw, topo, kept, device, prec)
    return compare.downscale(list(zip(got, want)))


def _downscale_weights(cell, seed, device):
    import numpy as np

    from portbench.reference import params as RP

    from windtpu_torch import api   # the bundled files' paths only

    with np.load(api.BUNDLED_GATE) as z:
        gate = {k: np.asarray(z[k]) for k in z.files}
    if cell.config["weights"] == "bundled":
        with np.load(api.BUNDLED_GENERATOR) as z:
            flat = {k.split("/", 1)[1].replace("/", "."): z[k]
                    for k in z.files}
        return flat, gate
    m = cell.config["model"]
    shapes, state = RP.generator(m["in_channels"], m["noise_channels"],
                                 m["out_channels"], m["generator_features"])
    p, s = inputs.weights(shapes, state, seed, device)
    return {k: v.cpu().numpy() for k, v in {**p, **s}.items()}, gate


def train_numbers(cell: H.Cell, seed: int, device, prec: Precision):
    from portbench.drivers import train as T

    cfg = T.gan_config(cell, seed)
    (gp, gs), (dp, ds) = T.weight_shapes(cfg)
    g_w = inputs.weights(gp, gs, H.subseed(seed, 10), device)
    d_w = inputs.weights(dp, ds, H.subseed(seed, 11), device)
    weights = {"g": g_w[0], "gs": g_w[1], "d": d_w[0], "ds": d_w[1]}
    if cell.traffic["feed"] == "batches":
        m = cfg.model
        shape = (cfg.train.batch_size, m.sequence_length, m.image_size,
                 m.image_size)
        batches = inputs.train_batches(seed, cell.traffic["batches"], shape,
                                       m.in_channels, m.out_channels,
                                       device)[:T.CHECKED_STEPS]
    else:
        batches = T.reference_batches(cell, cfg, seed, device)
    want = T.reference_steps(cfg, weights, batches, device)
    got = T.reference_steps(cfg, weights, batches, device, prec)
    return compare.train(got, want)


def numbers(cell: H.Cell, seed: int, device, prec: Precision) -> dict:
    if cell.driver == "downscale":
        return downscale_numbers(cell, seed, device, prec)
    return train_numbers(cell, seed, device, prec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = H.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    prec = lower(cell)
    for seed in args.seeds:
        out = numbers(cell, seed, device, prec)
        checks = H.checks_from(out, cell.spec["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": str(prec), "numbers": out,
                          "fails": [c.name for c in checks if not c.ok]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
