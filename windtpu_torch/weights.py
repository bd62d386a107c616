"""Carry weights and training state across from and to the JAX package's
flat format.

``windtpu/train/checkpoint.py:save_generator_npz`` writes the flax variable
tree as one ``.npz`` whose keys are '/'-joined paths: ``params/...``,
``batch_stats/...`` and ``spectral_stats/...``.  The port's modules keep the
flax names and layouts (HWIO kernels, BatchNorm ``mean``/``var``,
spectral-norm ``u``), so a key maps to the state-dict key by dropping the
collection and joining with '.'.  ``params`` entries must land on
parameters and the two stats collections on buffers; any key that is
missing, left over or of the wrong shape raises.

A whole training state travels as one flat dict of numpy arrays with the
field names of the JAX package's ``GANTrainState`` as prefixes:
``g_params/...``, ``g_batch_stats/...``, ``g_spectral/...``,
``d_params/...``, ``d_spectral/...``, ``step``, and the optimizer slots as
``g_opt/mu/<param path>``, ``g_opt/nu/<param path>``, ``g_opt/count``
(``optax.adam``'s moments; RMSprop has ``nu`` only) and the same under
``d_opt``.  The port never sees a JAX object: the caller flattens.
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
            f"weights do not match the module: missing={missing[:5]} "
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


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict of arrays as a flat dict with '/'-joined keys."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def load_autoencoder_npz(source, module: nn.Module) -> nn.Module:
    """Load autoencoder weights into the port's ``AutoEncoder`` in place.

    ``source`` is a ``save_generator_npz`` file of a flax autoencoder
    (e.g. the bundled ``windtpu/assets/weights/autoencoder-synth.npz``),
    its flat dict, or a JAX model's variables as a nested dict of numpy
    arrays.  Raises ``ValueError`` on a missing, extra or misshapen key,
    as :func:`load_flax_variables` does."""
    if isinstance(source, Mapping):
        return load_flax_variables(module, _flatten(source))
    return load_generator_npz(source, module)

def _to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A numpy copy that does not alias the live tensor."""
    return tensor.detach().cpu().numpy().copy()


def export_flax_variables(module: nn.Module) -> dict:
    """The reverse of :func:`load_flax_variables`: ``module``'s parameters
    and buffers as a flat flax variable dict of numpy copies."""
    flat = {}
    for name, p in module.named_parameters():
        flat["params/" + name.replace(".", "/")] = _to_numpy(p)
    for name, buf in module.named_buffers():
        collection = ("spectral_stats" if name.rsplit(".", 1)[-1] == "u"
                      else "batch_stats")
        flat[f"{collection}/" + name.replace(".", "/")] = _to_numpy(buf)
    return flat


# GANTrainState field prefix -> (network, flax collection).
_STATE_FIELDS = {
    "g_params": ("generator", "params"),
    "g_batch_stats": ("generator", "batch_stats"),
    "g_spectral": ("generator", "spectral_stats"),
    "d_params": ("discriminator", "params"),
    "d_spectral": ("discriminator", "spectral_stats"),
}


def load_train_state(state, flat: Mapping[str, np.ndarray]):
    """Fill the port's train ``state`` in place from a flat JAX train
    state (layout in the module docstring); raises on a missing, extra or
    misshapen key."""
    variables = {"generator": {}, "discriminator": {}}
    opt = {"g_opt": {}, "d_opt": {}}
    step = None
    for key, value in flat.items():
        field, _, path = key.partition("/")
        if key == "step":
            step = int(value)
        elif field in _STATE_FIELDS and path:
            network, collection = _STATE_FIELDS[field]
            variables[network][f"{collection}/{path}"] = value
        elif field in opt and path:
            slot, _, name = path.partition("/")
            if name:
                opt[field].setdefault(slot, {})[name.replace("/", ".")] = value
            else:
                opt[field][slot] = value
        else:
            raise ValueError(f"unexpected train-state key {key!r}")
    if step is None:
        raise ValueError("train state has no 'step'")
    for network, flat_vars in variables.items():
        load_flax_variables(getattr(state, network), flat_vars)
    state.g_opt.load_state_dict(opt["g_opt"])
    state.d_opt.load_state_dict(opt["d_opt"])
    state.step = step
    return state


def export_train_state(state) -> dict:
    """The reverse of :func:`load_train_state`."""
    flat = {"step": np.asarray(state.step, np.int32)}
    prefix = {v: k for k, v in _STATE_FIELDS.items()}
    for network in ("generator", "discriminator"):
        for key, value in export_flax_variables(
                getattr(state, network)).items():
            collection, _, path = key.partition("/")
            flat[f"{prefix[network, collection]}/{path}"] = value
    for name in ("g_opt", "d_opt"):
        for slot, value in getattr(state, name).state_dict().items():
            if slot == "count":
                flat[f"{name}/count"] = np.asarray(value, np.int32)
                continue
            for pname, tensor in value.items():
                flat[f"{name}/{slot}/" + pname.replace(".", "/")] = \
                    _to_numpy(tensor)
    return flat
