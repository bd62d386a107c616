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
  over two and four gloo ranks.
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


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fault", [None, "exchange"])
def test_ranks_need_their_exchange(fault, world):
    from windtpu_torch.utils.hostcpu import free_tcp_port

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = free_tcp_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    checks = queue.get(timeout=300)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    ok = all(c[3] for c in checks)
    assert ok == (fault is None), checks


def _started(monkeypatch, fault=None):
    """The arguments and keywords with which a multi-card run starts its
    other ranks (none of them runs)."""
    started = []

    class Done:
        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    class Stop(Exception):
        pass

    def popen(args, **kwargs):
        started.append((args, kwargs))
        return Done()

    def share(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(train_ranks.subprocess, "Popen", popen)
    monkeypatch.setattr(train_ranks, "share", share)
    cell = tiny.cell("train_main.dp4")
    with planted(fault) if fault else contextlib.nullcontext():
        with pytest.raises(Stop):
            train_ranks.run(cell, 5, 1.0, False, time.perf_counter())
    assert len(started) == cell.chips - 1
    return started


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_a_planted_fault_reaches_every_rank(fault, monkeypatch):
    """A multi-card run starts its other ranks with the fault planted in
    rank 0, so that all of them skip the same work."""
    for args, _ in _started(monkeypatch, fault):
        assert ("--fault" in args) == (fault is not None)
        if fault:
            assert args[args.index("--fault") + 1] == fault


def test_every_rank_has_one_thread(monkeypatch):
    """The other ranks start with one OpenMP thread, as torchrun starts
    several processes, and with the rest of rank 0's environment."""
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    for _, kwargs in _started(monkeypatch):
        env = kwargs["env"]
        assert env["OMP_NUM_THREADS"] == "1"
        assert env["PATH"] == train_ranks.os.environ["PATH"]
