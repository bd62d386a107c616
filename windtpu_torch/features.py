"""The perceptual feature encoder of the reconstruction loss (counterpart of
``windtpu/features.py``).

:func:`get_encoder_fn` builds the autoencoder, loads its weights and hands
out its encoder as the feature extractor, with the parameters frozen: the
gradient flows to the input only.  Resolution order, as in the JAX
package:

1. the newest ``$CHECKPOINT_ROOT/autoencoder/step_<N>.npz``, a flat flax
   variable file (``windtpu.train.checkpoint.save_generator_npz`` of the
   autoencoder's variables).  The JAX package keeps orbax ``step_<N>``
   directories there, which the port cannot read: the newest entry being
   such a directory raises, naming that export, rather than falling
   through to other weights;
2. the bundled ``windtpu/assets/weights/autoencoder-synth.npz`` (read in
   place), when its shapes fit the requested geometry (96 px, latent 96);
3. random initialisation, with the JAX package's warning.

Encoders are cached per (image size, time steps, latent size, device).
"""

from __future__ import annotations

import os
import re
import zipfile
from pathlib import Path
from typing import Callable

import torch

from windtpu_torch.core.device import resolve_device
from windtpu_torch.models.autoencoder import AutoEncoder
from windtpu_torch.models.layers import init_variables
from windtpu_torch.weights import load_autoencoder_npz

BUNDLED_AUTOENCODER = (Path(__file__).resolve().parents[1] / "windtpu"
                       / "assets" / "weights" / "autoencoder-synth.npz")

_cache = {}


def checkpoint_path() -> Path:
    root = Path(os.getenv("CHECKPOINT_ROOT", "./checkpoints"))
    return root / "autoencoder"


def build_autoencoder(image_size: int = 96, time_steps: int = 24,
                      latent_dimension: int = 96,
                      device=None) -> AutoEncoder:
    """An autoencoder with random weights (seed 0) on ``device``."""
    model = AutoEncoder(image_size=image_size, time_steps=time_steps,
                        latent_dimension=latent_dimension)
    return init_variables(model, seed=0).to(resolve_device(device))


def _newest_checkpoint(ckpt_dir: Path):
    """The newest ``step_<N>`` entry of ``ckpt_dir`` by N, or None; raises
    where it is an orbax directory."""
    if not ckpt_dir.is_dir():
        return None
    steps = []
    for entry in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)(\.npz)?", entry.name)
        if m and (entry.is_dir() or m.group(2)):
            steps.append((int(m.group(1)), entry))
    if not steps:
        return None
    newest = max(steps)[1]
    if newest.is_dir():
        raise ValueError(
            f"{newest} is an orbax checkpoint, which the port cannot read; "
            f"export the autoencoder's variables with "
            f"windtpu.train.checkpoint.save_generator_npz to "
            f"{ckpt_dir}/step_<N>.npz")
    return newest


def get_encoder_fn(image_size: int = 96, time_steps: int = 24,
                   latent_dimension: int = 96,
                   device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``f(x: (B, T, I, I, 2)) -> (B, T, latent)`` on ``device`` (``None``
    means the card), from the weights the module docstring's order
    finds.  ``f.source`` names them: the checkpoint's or the bundled
    file's path, or ``"random"``."""
    device = resolve_device(device)
    key = (image_size, time_steps, latent_dimension, str(device))
    if key in _cache:
        return _cache[key]
    model = build_autoencoder(image_size, time_steps, latent_dimension,
                              device)
    ckpt_dir = checkpoint_path()
    newest = _newest_checkpoint(ckpt_dir)
    loaded = newest is not None
    if loaded:
        load_autoencoder_npz(newest, model)
    elif BUNDLED_AUTOENCODER.exists():
        try:
            load_autoencoder_npz(BUNDLED_AUTOENCODER, model)
            loaded = True
        except ValueError:
            # The bundled weights are the flagship geometry's; other image
            # or latent sizes fall through to random weights.
            pass
        except (OSError, EOFError, zipfile.BadZipFile) as e:
            print(f"warning: bundled autoencoder weights unreadable "
                  f"({e!r}); falling back")
    if not loaded:
        print(f"warning: no autoencoder checkpoint at {ckpt_dir} and no "
              "matching bundled weights; encoder uses random "
              "initialization")
    model.eval().requires_grad_(False)

    def encode(x: torch.Tensor) -> torch.Tensor:
        return model.encode(x)

    encode.source = str(newest or (BUNDLED_AUTOENCODER if loaded
                                   else "random"))
    _cache[key] = encode
    return encode
