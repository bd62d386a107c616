"""Data-parallel train driver: the ``train`` driver on one NCCL rank per
card, the global batch split over the ranks, as ``torchrun`` would start
them (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; ``parallel.initialize_distributed`` reads them).

The process the benchmark starts is rank 0: it starts the other ranks as
processes of the same entry point (``--rank r``), runs its own share, and
after the window gathers the peak memory (the fullest card) and the busy
time (averaged over the cards), lets the others exit, and compares its
checked steps with the reference on the whole global batch.  A rank that
fails ends the run.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import torch

from portbench import harness as H
from portbench.drivers import train as T

JOIN_TIMEOUT = 120.0
FLOPS_UNIT = T.FLOPS_UNIT


def _join(rank: int, world: int, port: int, device: str):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from windtpu_torch.core.mesh import make_mesh
    from windtpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(device=device)
    if device == "cpu":
        return torch.device("cpu"), make_mesh({"data": world})
    return (torch.device("cuda", torch.cuda.current_device()),
            make_mesh({"data": world}))


def share(cell, seed, seconds, trace, t_start, rank, world, port,
          device="cuda"):
    """This rank's run; returns its device, its result, the fullest
    card's peak and the busy time averaged over the cards.  ``device``
    "cpu" runs the ranks over gloo on the CPU, as the tests do."""
    import torch.distributed as dist

    device, mesh = _join(rank, world, port, device)

    def stop(closed: bool) -> bool:
        flag = torch.tensor([int(closed)], device=device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    r = T.run_rank(cell, seed, seconds, trace, t_start, device, mesh, stop)
    peak = torch.tensor([r.memory_peak], dtype=torch.float64, device=device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    busy = torch.tensor([r.busy_s or 0.0], dtype=torch.float64,
                        device=device)
    dist.all_reduce(busy)
    dist.destroy_process_group()
    return device, r, int(peak.item()), float(busy.item()) / world


def rank_main(cell: H.Cell, seed: int, seconds: float, trace: bool,
              t_start: float, rank: int, world: int, port: int) -> None:
    share(cell, seed, seconds, trace, t_start, rank, world, port)


def _watch(procs) -> None:
    """End the run when another rank fails: rank 0 would wait for it in
    a collective until the group's timeout."""
    while True:
        for p in procs:
            code = p.poll()
            if code not in (None, 0):
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                print(f"# a rank exited with {code}; ending the run",
                      file=sys.stderr, flush=True)
                os._exit(3)
        if all(p.poll() is not None for p in procs):
            return
        time.sleep(0.5)


def run(cell: H.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> H.Outcome:
    from windtpu_torch.utils.hostcpu import free_tcp_port

    world = cell.chips
    port = free_tcp_port()
    args = [sys.executable, "-m", "portbench.run", "--workload", cell.name,
            "--seed", str(seed), "--seconds", str(seconds), "--trace",
            str(int(trace)), "--world", str(world), "--port", str(port)]
    procs = [subprocess.Popen(args + ["--rank", str(r)], cwd=H.ROOT,
                              stdout=sys.stderr, stderr=sys.stderr)
             for r in range(1, world)]
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        device, r, peak, busy = share(cell, seed, seconds, trace, t_start,
                                      0, world, port)
    finally:
        deadline = time.monotonic() + JOIN_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    r.outcome_run.busy_s = busy if trace else None
    return T.outcome(cell, seed, r, device, peak)
