"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell needs.
It makes its inputs from the seed, sets up and warms up (``setup_s``),
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and,
traced, ``breakdown``; ``checks`` last, each compared number beside its
limit, which also end standard error.  Everything the program prints goes
to standard error.  Without the cards, or if JAX or the JAX package is
loaded, it exits with another code than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # A rank of a multi-card cell, started by its rank 0.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def device_block(chips: int, memory_peak: int, run, trace: bool) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(memory_peak)}
    if trace and run.trace is not None:
        out["busy_s"] = run.busy_s
        out["window_s"] = run.trace.window_s
    return out


def result(cell, outcome, trace: bool) -> dict:
    from portbench import harness as H

    run = outcome.run
    if trace:
        metrics = H.per_layer(run)
    else:
        metrics = {"setup_s": {"value": outcome.setup_s, "unit": "s"}}
        metrics.update({k: {"value": v, "unit": "s"}
                        for k, v in outcome.end_to_end.items()})
    res = {"correct": all(c.ok for c in outcome.checks),
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics,
           "device": device_block(cell.chips, outcome.memory_peak, run,
                                  trace)}
    if trace and run.trace is not None:
        res["breakdown"] = {"device_ops": H.device_ops(run.trace),
                            "idle_gaps": H.idle_gaps(run.trace)}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return res


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness as H

    try:
        cell = H.load_cell(args.workload)
    except FileNotFoundError as e:
        print(f"no such cell: {e}", file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {cards} "
              "available", file=sys.stderr)
        return 2
    driver = H.driver_module(cell.driver)
    trace = bool(args.trace)
    if args.rank is not None:
        with contextlib.redirect_stdout(sys.stderr):
            driver.rank_main(cell, args.seed, args.seconds, trace, T_START,
                             args.rank, args.world, args.port)
        return 0
    with contextlib.redirect_stdout(sys.stderr):
        outcome = driver.run(cell, args.seed, args.seconds, trace, T_START)
        res = result(cell, outcome, trace)
    loaded = H.forbidden_modules(sys.modules)
    if loaded:
        print(f"refused: the run loaded {loaded}", file=sys.stderr)
        return 3
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
