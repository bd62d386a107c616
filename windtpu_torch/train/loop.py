"""Training loop: batches -> train step -> logging and checkpoints
(counterpart of ``windtpu/train/loop.py``, single device)."""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import torch

from windtpu_torch.core.config import GANConfig
from windtpu_torch.train import checkpoint as ckpt
from windtpu_torch.train.state import GANTrainState, create_train_state
from windtpu_torch.train.wgan_gp import make_multi_train_step, make_train_step
from windtpu_torch.utils.logging import MetricsLogger


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
):
    """Run ``num_steps`` WGAN-GP updates over ``batches`` of
    (low_res, high_res) arrays.  Returns (state, history).

    Without ``state`` a fresh one is made on ``device`` (``None`` means the
    card).  With ``cfg.checkpoint_dir`` the latest checkpoint there is
    restored first, checkpoints are written every ``checkpoint_every``
    steps and at the end, and the logged metrics go to ``metrics.jsonl``
    beside them.  ``TrainConfig.steps_per_call`` = K runs K steps per call
    and reports the last one's metrics; a remainder runs step by step.
    ``profile_dir`` gets a ``torch.profiler`` trace of calls 2 and 3."""
    if state is None:
        state = create_train_state(cfg, device=device)
    metrics_logger = None
    if cfg.checkpoint_dir:
        latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
        if latest:
            state = ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} (step {state.step})")
        metrics_logger = MetricsLogger(
            f"{cfg.checkpoint_dir}/metrics.jsonl")

    k = max(1, cfg.train.steps_per_call)
    single_fn = make_train_step(cfg)
    multi_fn = make_multi_train_step(cfg, k) if k > 1 else single_fn
    rng = torch.Generator(device=state.device).manual_seed(cfg.seed + 1)
    history = []
    it = iter(batches)
    t_last = time.perf_counter()
    steps_since_log = 0
    local_step = 0
    call_idx = 0
    profiler = None
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
            profiler = _start_profiler(state.device)
        state, metrics = fn(state, low_res, high_res, rng)
        if profiler is not None and call_idx == 3:
            _stop_profiler(profiler, profile_dir, state.device)
            profiler = None
        prev = local_step
        local_step += this_k
        steps_since_log += this_k
        call_idx += 1
        # Stride-aware cadences: fire when a multiple was CROSSED, not only
        # when it is landed on exactly (k need not divide the cadence).
        if (prev // log_every != local_step // log_every
                or local_step == this_k):
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
            else:
                msg = " ".join(f"{key}={v:.4g}"
                               for key, v in metrics.items())
                print(f"step {state.step}: {msg}")
        if (cfg.checkpoint_dir and checkpoint_every
                and prev // checkpoint_every
                != local_step // checkpoint_every):
            ckpt.save_checkpoint(cfg.checkpoint_dir, state)
    if profiler is not None:  # num_steps ended inside the trace window
        _stop_profiler(profiler, profile_dir, state.device)
    if cfg.checkpoint_dir:
        ckpt.save_checkpoint(cfg.checkpoint_dir, state)
    if metrics_logger:
        metrics_logger.close()
    return state, history


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
