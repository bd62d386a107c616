"""Training loop: batches -> train step -> logging and checkpoints
(counterpart of ``windtpu/train/loop.py``), on one device or, with a
mesh, on every rank of a data-parallel run."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from windtpu_torch.core.config import GANConfig
from windtpu_torch.core.mesh import Mesh, world
from windtpu_torch.features import get_encoder_fn
from windtpu_torch.parallel.distributed import agree, replicate_to_mesh
from windtpu_torch.train import checkpoint as ckpt
from windtpu_torch.train.state import GANTrainState, create_train_state
from windtpu_torch.train.wgan_gp import make_multi_train_step, make_train_step
from windtpu_torch.utils.logging import MetricsLogger, profile_region, span


def train(
    cfg: GANConfig,
    batches: Iterable,
    num_steps: int,
    state: Optional[GANTrainState] = None,
    log_every: int = 10,
    checkpoint_every: Optional[int] = None,
    log_fn: Callable[[int, dict], None] = None,
    profile_dir: Optional[str] = None,
    device=None,
    mesh: Optional[Mesh] = None,
):
    """Run ``num_steps`` WGAN-GP updates over ``batches`` of
    (low_res, high_res) arrays.  Returns (state, history).

    With ``mesh`` (every rank runs the loop) the batches are this rank's
    rows of each global batch (``BatchGenerator.as_device_iterator(mesh=
    mesh)``) and the step is the global-batch step of
    :func:`windtpu_torch.train.wgan_gp.make_train_step`: equal to the
    single-process step on the whole batch.  Every rank restores the same
    checkpoint step or none (a disagreement raises on every rank), rank
    0's state is broadcast to all before the first step, the step's seed
    is checked across ranks, and a barrier precedes the first step.  Only
    rank 0 writes checkpoints and ``metrics.jsonl`` and prints.

    Without ``state`` a fresh one is made on ``device`` (``None`` means the
    card).  With ``cfg.checkpoint_dir`` the latest checkpoint there is
    restored first, checkpoints are written every ``checkpoint_every``
    steps and at the end, and the logged metrics go to ``metrics.jsonl``
    beside them.  ``TrainConfig.steps_per_call`` = K runs K steps per call
    and reports the last one's metrics; a remainder runs step by step.
    ``TrainConfig.reconstruction_coefficient > 0`` adds the perceptual
    loss through :func:`windtpu_torch.features.get_encoder_fn` at the
    model's image size and sequence length.  ``profile_dir`` gets a
    ``torch.profiler`` trace of calls 2 and 3."""
    if state is None:
        state = create_train_state(cfg, device=device)
    lead = world()[0] == 0
    metrics_logger = None
    if cfg.checkpoint_dir:
        latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
        if mesh is not None:
            # An unshared checkpoint directory, or a rank that lags a save,
            # would restore different states; the broadcast below would
            # then hide it behind rank 0's.
            agree(int(latest.rsplit("step_", 1)[1][:-3]) if latest else -1,
                  f"the checkpoint step to restore from "
                  f"{cfg.checkpoint_dir} (-1: none); the directory must "
                  f"be shared, or equally replicated, across ranks")
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            if lead:
                print(f"resumed from {latest} (step {state.step})")
        if lead:
            metrics_logger = MetricsLogger(
                f"{cfg.checkpoint_dir}/metrics.jsonl")

    # The perceptual reconstruction loss: its encoder (checkpointed,
    # bundled or random, features.get_encoder_fn) on the state's device.
    feature_fn = None
    if cfg.train.reconstruction_coefficient > 0:
        feature_fn = get_encoder_fn(cfg.model.image_size,
                                    cfg.model.sequence_length,
                                    device=state.device)
    k = max(1, cfg.train.steps_per_call)
    single_fn = make_train_step(cfg, feature_fn=feature_fn, mesh=mesh)
    multi_fn = (make_multi_train_step(cfg, k, feature_fn=feature_fn,
                                      mesh=mesh)
                if k > 1 else single_fn)
    seed = cfg.seed + 1
    if mesh is not None:
        replicate_to_mesh(mesh, [state.generator, state.discriminator,
                                 state.g_opt.state, state.d_opt.state])
        for opt in (state.g_opt, state.d_opt):
            opt.count = agree(opt.count, "the optimizer step count")
        state.step = agree(state.step, "the step")
        seed = agree(seed, "the seed")
        if world()[1] > 1:
            # NCCL's barrier runs on a card: name this rank's (the current
            # one, as initialize_distributed set it), or torch picks one
            # and warns.
            dist.barrier(device_ids=[torch.cuda.current_device()]
                         if dist.get_backend() == "nccl" else None)
    rng = torch.Generator(device=state.device).manual_seed(seed)
    history = []
    it = iter(batches)
    t_last = time.perf_counter()
    steps_since_log = 0
    local_step = 0
    call_idx = 0
    profiling = contextlib.ExitStack()
    while local_step < num_steps:
        this_k = k if (num_steps - local_step) >= k else 1
        if this_k > 1:
            pairs = [next(it) for _ in range(k)]
            low_res = tuple(p[0] for p in pairs)
            high_res = tuple(p[1] for p in pairs)
            fn = multi_fn
        else:
            low_res, high_res = next(it)
            fn = single_fn
        # Profile calls 2..3, past the kernels' build and the warm-up.
        if profile_dir and call_idx == 2:
            profiling.enter_context(profile_region(profile_dir))
        state, metrics = fn(state, low_res, high_res, rng)
        if call_idx == 3:
            profiling.close()
        prev = local_step
        local_step += this_k
        steps_since_log += this_k
        call_idx += 1
        # Stride-aware cadences: fire when a multiple was CROSSED, not only
        # when it is landed on exactly (k need not divide the cadence).
        if (prev // log_every != local_step // log_every
                or local_step == this_k):
            # The host waits here for the step's last work on the device.
            with span("loop.readout"):
                metrics = {key: float(v) for key, v in metrics.items()}
            now = time.perf_counter()
            metrics["steps_per_sec"] = (
                1.0 if local_step == this_k
                else steps_since_log / (now - t_last))
            t_last = now
            steps_since_log = 0
            history.append((state.step, metrics))
            if metrics_logger:
                metrics_logger(state.step, metrics)
            if log_fn:
                log_fn(state.step, metrics)
            elif lead:
                msg = " ".join(f"{key}={v:.4g}"
                               for key, v in metrics.items())
                print(f"step {state.step}: {msg}")
        if (cfg.checkpoint_dir and checkpoint_every and lead
                and prev // checkpoint_every
                != local_step // checkpoint_every):
            with span("loop.checkpoint"):
                ckpt.save_checkpoint(cfg.checkpoint_dir, state)
    profiling.close()  # num_steps may end inside the trace window
    if cfg.checkpoint_dir and lead:
        with span("loop.checkpoint"):
            ckpt.save_checkpoint(cfg.checkpoint_dir, state)
    if metrics_logger:
        metrics_logger.close()
    return state, history
