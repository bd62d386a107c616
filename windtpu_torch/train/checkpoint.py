"""Checkpointing (counterpart of ``windtpu/train/checkpoint.py``): one
``torch.save`` file ``step_%08d.pt`` per step with the whole train state
(both networks, their statistics, both optimizers, the step), and the
single-file generator weights in the JAX package's flat ``.npz`` layout."""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from windtpu_torch.train.state import GANTrainState
from windtpu_torch.weights import export_flax_variables


def save_checkpoint(directory, state: GANTrainState,
                    step: Optional[int] = None) -> str:
    directory = os.path.abspath(os.fspath(directory))
    step = state.step if step is None else int(step)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    if os.path.exists(path):
        # Same step == same state: the in-loop cadence save and the final
        # save can both land on num_steps.
        return path
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": state.step,
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
    }
    # Written under a name latest_checkpoint does not match, then renamed:
    # an interrupted save leaves no half-written step_*.pt behind.
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory) -> Optional[str]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    # Full-match step_<digits>.pt only: a partial file's name sorts AFTER
    # the finished checkpoint, and a prefix match would resume from it.
    steps = sorted(d for d in os.listdir(directory)
                   if re.fullmatch(r"step_\d+\.pt", d))
    return (os.path.join(os.path.abspath(directory), steps[-1])
            if steps else None)


def restore_checkpoint(path, state: GANTrainState) -> GANTrainState:
    """Restore the checkpoint at ``path`` into ``state`` (an initialized
    state of the same configuration), in place, on the state's device."""
    payload = torch.load(os.fspath(path), map_location=state.device,
                         weights_only=True)
    state.generator.load_state_dict(payload["generator"], strict=True)
    state.discriminator.load_state_dict(payload["discriminator"],
                                        strict=True)
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.step = int(payload["step"])
    return state


def save_generator_npz(path, generator) -> str:
    """Write ``generator``'s variables as one compressed ``.npz`` whose keys
    are '/'-joined flax paths, the layout that
    ``windtpu/train/checkpoint.py:load_generator_npz`` and
    :func:`windtpu_torch.weights.load_generator_npz` read."""
    path = os.fspath(path)
    with open(path, "wb") as fp:
        np.savez_compressed(fp, **export_flax_variables(generator))
    return path
