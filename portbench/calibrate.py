"""The two readings each correctness limit is set from, at a cell's own
size on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 \
        --faults half_batch state train_answer

prints one JSON line per run: the program's numbers on ``--seeds`` seeds
(a run of the cell with a 1-second window, in a process of its own as
the benchmark starts it; the numbers come from the checked steps or the
sampled days), each named fault of ``portbench.faults`` planted in the
program (in every rank of a multi-card cell) on 3 seeds, then the
control's (``portbench.control``, in this process) on 3 seeds.  The
lower reading of a number is the largest sound one; the upper the
smallest control reading 3x the lower or more, or fault reading 10x (a
state left unchanged: 3x).  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from portbench import control
from portbench import harness as H


def program(cell: H.Cell, seed: int, fault=None) -> dict:
    """The compared numbers of one run, or its exit code where it ended
    without a result."""
    args = [sys.executable, "-m", "portbench.run", "--workload", cell.name,
            "--seed", str(seed), "--seconds", "1", "--trace", "0"]
    if fault:
        args += ["--fault", fault]
    out = subprocess.run(args, cwd=H.ROOT, stdout=subprocess.PIPE,
                         text=True)
    if out.returncode:
        return {"exit": out.returncode}
    checks = json.loads(out.stdout.strip().splitlines()[-1])["checks"]
    return {k: c["value"] for k, c in checks.items()}


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
    for fault in args.faults:
        for i in range(3):
            seed = args.first_seed + 2 * 10 ** 8 + 7919 * i
            line(fault, seed, program(cell, seed, fault))
    for i in range(3):
        seed = args.first_seed + 10 ** 8 + 7919 * i
        line("control", seed, control.numbers(cell, seed, device,
                                              control.lower(cell)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
