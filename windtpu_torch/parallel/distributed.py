"""Multi-process set-up (counterpart of ``windtpu/parallel/distributed.py``).

One process per device: :func:`initialize_distributed` joins this process
to the process group over ``tcp://`` and gives it its card,
``cuda:{local_rank}``, or the CPU when asked.  Collectives then run over
the groups of a :class:`windtpu_torch.core.mesh.Mesh`.  The backend is
explicit: NCCL for a CUDA device and gloo for the CPU unless the caller
names one (gloo also takes CUDA tensors, which is how two ranks can share
one card); a failed initialisation raises and nothing falls back.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Mapping, Optional

import torch
import torch.distributed as dist

from windtpu_torch.core.device import resolve_device
from windtpu_torch.core.mesh import Mesh, collective_device, make_mesh, world

# torchrun's variables, which name the process group without arguments.
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group when running multi-process.

    A no-op that returns False in a single process with no arguments and
    no ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``).  Otherwise the arguments (``host:port`` of rank 0,
    the number of processes, this one's rank), or torchrun's variables
    where they are not given, name the group.  Before anything resolves a
    device, a CUDA rank takes ``cuda:{local_rank}`` as its current card
    (``LOCAL_RANK``, else the rank modulo the cards of this host), so that
    ``device=None`` means this rank's card everywhere after.  ``device``
    ("cpu", "cuda" or "cuda:N"; None means the card) picks the default
    backend: "nccl" on a card, "gloo" on the CPU; ``backend`` overrides
    it.  Returns True once the group exists (also when it existed)."""
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None
            and not all(env.get(k) for k in _TORCHRUN_ENV)):
        return False
    if dist.is_initialized():
        if num_processes is not None and \
                dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"the process group has {dist.get_world_size()} processes, "
                f"not {num_processes}")
        return True
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    missing = [flag for flag, value in (
        ("--coordinator-address", coordinator_address),
        ("--num-processes", num_processes),
        ("--process-id", process_id)) if value is None]
    if missing:
        raise ValueError(
            f"a multi-process run needs {', '.join(missing)} (or torchrun's "
            f"MASTER_ADDR, WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", int(env.get(
                "LOCAL_RANK", process_id % torch.cuda.device_count())))
        dev = resolve_device(dev)        # raises without a card
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(minutes=10))
    return True


def global_data_mesh(ensemble: int = 1) -> Mesh:
    """All-rank mesh: ('data',) or ('data', 'ensemble')."""
    n = world()[1]
    if ensemble > 1:
        return make_mesh({"data": n // ensemble, "ensemble": ensemble})
    return make_mesh({"data": n})


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"cannot replicate a {type(tree).__name__}")


@torch.no_grad()
def replicate_to_mesh(mesh: Mesh, tree):
    """Overwrite every tensor of ``tree`` (tensors, modules' parameters and
    buffers, lists and dicts of them) with rank 0's, in place, by
    broadcast over the whole process group; returns ``tree``.  The
    counterpart of the JAX package's assembling of a replicated state from
    process-local copies, which its callers must keep identical; here rank
    0's wins.  (JAX's ``core.mesh.replicate`` places one process's array on
    its devices; with one process per device there is nothing to place.)"""
    if world()[1] > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data, src=0)
    return tree


def agree(value: int, what: str) -> int:
    """``value`` checked against rank 0's by broadcast: every rank raises
    when any rank disagrees (one all-reduce of the ranks' values into a
    zero-filled tensor), so no rank is left waiting on another that
    stopped.  With the seed as ``value`` it is the counterpart of
    ``key_on_mesh``: the ranks' generators seeded with it draw the same
    numbers."""
    rank, n = world()
    if n == 1:
        return int(value)
    seen = torch.zeros(n, dtype=torch.int64, device=collective_device())
    seen[rank] = int(value)
    dist.all_reduce(seen)
    if (seen != seen[0]).any():
        raise RuntimeError(f"the ranks disagree on {what}: "
                           f"{seen.tolist()} (rank 0 first)")
    return int(seen[0])

