"""Carry generator weights across from the JAX package's flat format.

``windtpu/train/checkpoint.py:save_generator_npz`` writes the flax variable
tree as one ``.npz`` whose keys are '/'-joined paths: ``params/...``,
``batch_stats/...`` and ``spectral_stats/...``.  The port's modules keep the
flax names and layouts (HWIO kernels, BatchNorm ``mean``/``var``,
spectral-norm ``u``), so a key maps to the state-dict key by dropping the
collection and joining with '.'.  ``params`` entries must land on
parameters and the two stats collections on buffers; any key that is
missing, left over or of the wrong shape raises.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

_COLLECTIONS = {"params": "parameter", "batch_stats": "buffer",
                "spectral_stats": "buffer"}


def _torch_key(flax_key: str) -> str:
    collection, _, path = flax_key.partition("/")
    if collection not in _COLLECTIONS or not path:
        raise ValueError(f"unexpected variable {flax_key!r}: expected a "
                         f"path under one of {sorted(_COLLECTIONS)}")
    return path.replace("/", ".")


@torch.no_grad()
def load_flax_variables(module: nn.Module,
                        flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a flat flax variable dict into ``module`` in place, checking
    names, collections and shapes first."""
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    kinds = {**{k: "parameter" for k in params},
             **{k: "buffer" for k in buffers}}
    by_key = {}
    wrong_kind = []
    for key, value in flat.items():
        tkey = _torch_key(key)
        if tkey in kinds and kinds[tkey] != _COLLECTIONS[key.split("/")[0]]:
            wrong_kind.append(key)
        by_key[tkey] = value
    missing = sorted(set(kinds) - set(by_key))
    extra = sorted(set(by_key) - set(kinds))
    if missing or extra or wrong_kind:
        raise ValueError(
            f"weights do not match the generator: missing={missing[:5]} "
            f"extra={extra[:5]} wrong_collection={wrong_kind[:5]}")
    target = {**params, **buffers}
    state = {}
    for tkey, value in by_key.items():
        want = tuple(target[tkey].shape)
        if tuple(np.shape(value)) != want:
            raise ValueError(f"{tkey}: shape {tuple(np.shape(value))} != "
                             f"expected {want} (different ModelConfig?)")
        state[tkey] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))
    module.load_state_dict(state, strict=True)
    return module


def load_generator_npz(path, module: nn.Module) -> nn.Module:
    """Load a ``save_generator_npz`` file (e.g. the bundled
    ``windtpu/assets/weights/generator-synth.npz``) into ``module``."""
    with np.load(os.fspath(path)) as data:
        flat = {k: data[k] for k in data.files}
    return load_flax_variables(module, flat)
