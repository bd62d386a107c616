"""A whole run of each cell, at a tiny size on the CPU and past the look
for a card, with the cells' own limits: sound, it comes out correct;
with the timed path broken underneath in each way the cell can break, it
does not.  The faults are planted in the port in memory:

- an answer altered where it is produced (the downscale: one patch of
  each generator group off by 2 m/s; training: the generator's output
  off by 2 m/s in every step);
- a step that returns its state unchanged (Adam's update skipped);
- half of the batch left out, the mean taken over the rest;
- the exchange between the cards left out (every all-reduce skipped),
  over two gloo ranks.
"""

import contextlib
import multiprocessing
import time

import pytest
import torch

from portbench.drivers import downscale, train, train_ranks
from portbench.faults import planted
from portbench.tests import tiny


def _run(name, fault=None, seconds=1.0):
    cell = tiny.f32(tiny.cell(name))
    driver = downscale if cell.driver == "downscale" else train
    with planted(fault) if fault else contextlib.nullcontext():
        out = driver.run(cell, 2 ** 40 + 17, seconds, False,
                         time.perf_counter(), device="cpu")
    return out


@pytest.mark.parametrize("name", ["flagship.downscale", "flagship.train",
                                  "train_main.synthetic"])
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out.attempted >= 1
    assert all(c.ok for c in out.checks), [(c.name, c.value, c.limit)
                                          for c in out.checks]


@pytest.mark.parametrize("name,fault", [
    ("flagship.downscale", "answer"),
    ("flagship.train", "train_answer"),
    ("flagship.train", "state"),
    ("flagship.train", "half_batch"),
    ("train_main.synthetic", "state"),
    ("train_main.synthetic", "half_batch"),
])
def test_a_broken_run_is_not_correct(name, fault):
    out = _run(name, fault)
    assert not all(c.ok for c in out.checks), [(c.name, c.value, c.limit)
                                              for c in out.checks]


def _rank(rank, world, port, fault, queue):
    torch.set_num_threads(1)
    cell = tiny.f32(tiny.cell("train_main.dp4"))
    with planted(fault) if fault else contextlib.nullcontext():
        device, r, peak, _ = train_ranks.share(
            cell, 2 ** 40 + 17, 1.0, False, time.perf_counter(), rank,
            world, port, device="cpu")
    if rank == 0:
        out = train.outcome(cell, 2 ** 40 + 17, r, device, peak)
        queue.put([(c.name, c.value, c.limit, c.ok) for c in out.checks])


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_two_ranks_need_their_exchange(fault):
    from windtpu_torch.utils.hostcpu import free_tcp_port

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_tcp_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    checks = queue.get(timeout=300)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    ok = all(c[3] for c in checks)
    assert ok == (fault is None), checks
