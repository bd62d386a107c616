"""The two readings each correctness limit is set from, at a cell's own
size on the card, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 \
        --faults half_batch state train_answer

prints one JSON line per run: the program's numbers on ``--seeds`` seeds
(the cell's driver with a 1-second window; the numbers come from the
checked steps or the sampled days), the control's (``portbench.control``)
on 3 seeds, and each named fault of ``portbench.faults`` planted in the
program on 3 seeds.  The lower reading of a number is the largest sound
one; the upper the smallest control reading 3x the lower or more, or
fault reading 10x (a state left unchanged: 3x).  The benchmark's runs
never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import control
from portbench import harness as H
from portbench.faults import planted


def program(cell: H.Cell, seed: int, fault=None) -> dict:
    driver = H.driver_module(cell.driver)
    with contextlib.redirect_stdout(sys.stderr), \
            (planted(fault) if fault else contextlib.nullcontext()):
        out = driver.run(cell, seed, 1.0, False, time.perf_counter())
    return {c.name: c.value for c in out.checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=8000000000)
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    cell = H.load_cell(args.workload)
    device = torch.device("cuda", 0)

    def line(who, seed, numbers):
        print(json.dumps({"who": who, "seed": seed, **numbers}), flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        line("program", seed, program(cell, seed))
    for i in range(3):
        seed = args.first_seed + 10 ** 8 + 7919 * i
        line("control", seed, control.numbers(cell, seed, device,
                                              control.lower(cell)))
    for fault in args.faults:
        for i in range(3):
            seed = args.first_seed + 2 * 10 ** 8 + 7919 * i
            line(fault, seed, program(cell, seed, fault))
    return 0


if __name__ == "__main__":
    sys.exit(main())
