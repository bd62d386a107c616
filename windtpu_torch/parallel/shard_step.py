"""Explicit-collective data-parallel train step (counterpart of
``windtpu/parallel/shard_step.py``).

Each rank runs the step on its own shard of the batch and averages the
gradients and metrics over the mesh's ``axis`` before the optimizers
move, as the JAX package's ``shard_map`` step pmeans them: its own draws,
BatchNorm over its local batch, the running statistics averaged once at
the end of the step.  The state is replicated: every rank holds the same
one (:func:`windtpu_torch.parallel.replicate_to_mesh`) and moves it the
same way.  ``train_main`` and ``train.loop.train(mesh=...)`` run the
global-batch step instead (``make_train_step(cfg, mesh=mesh)``), which
equals the single-process step on the whole batch.
"""

from __future__ import annotations

from windtpu_torch.core.config import GANConfig
from windtpu_torch.core.mesh import Mesh
from windtpu_torch.train.wgan_gp import make_train_step


def make_sharded_train_step(cfg: GANConfig, mesh: Mesh, axis: str = "data"):
    """``(state, low_res, high_res, rng=None, *, draws=None) -> (state,
    metrics)`` on this rank's shard of the batch, with explicit all-reduce
    means over ``axis``."""
    return make_train_step(cfg, mesh=mesh, axis=axis, pmean_step=True)
