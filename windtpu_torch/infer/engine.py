"""Tiled inference engine, single device (counterpart of the monolithic
predictor in ``windtpu/infer/engine.py``).

The whole (T, H, W, C) field and the output canvas stay on the device:

  pass 1  over patch groups: NaN-aware sum / sum of squares of the
          stacked patch tensor -> normalization statistics;
  pass 2  over patch groups: gather patches, normalize, run the generator
          with fresh per-group noise, crop the 2-px border, and add the
          predictions into the canvas; finally divide by the host-computed
          coverage map (NaN where no patch lands).

Kept from the JAX engine: patches are fed lat-reversed and un-reversed on
output; ``replicate_normalization_quirk`` gives per-(lon, channel)
statistics with padded patches weighted out; ``std == 0 -> 1``.  Noise is
one draw per patch group, in group order, from the caller's
``torch.Generator``; it cannot reproduce JAX's ``fold_in`` streams.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from windtpu_torch.core.config import InferenceConfig, ModelConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.infer.tiling import TilingPlan

ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _pad_to_multiple(arr: np.ndarray, multiple: int):
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
    weights = np.concatenate([np.ones(n, np.float32),
                              np.zeros(pad, np.float32)])
    return arr, weights


def _coverage_counts(plan: TilingPlan, origins_g: np.ndarray,
                     weights_g: np.ndarray, crop: int) -> np.ndarray:
    """Static (T, H, W, 1) patch-coverage map for the overlap mean."""
    img = plan.image_size
    seq = plan.sequence_length
    counts = np.zeros(
        (plan.time_window, plan.pixels_lat, plan.pixels_lon, 1), np.float32)
    for (sx, sy, k), w in zip(origins_g.reshape(-1, 3).tolist(),
                              weights_g.ravel().tolist()):
        if w:
            counts[k * seq:(k + 1) * seq, sy + crop:sy + img - crop,
                   sx + crop:sx + img - crop] += w
    return counts


def _grouped_origins(plan: TilingPlan, group: int):
    """(G, group, 3) int32 origins + (G, group) validity weights."""
    origins_np, weights_np = _pad_to_multiple(
        plan.patch_origins().astype(np.int32), group)
    return origins_np.reshape(-1, group, 3), weights_np.reshape(-1, group)


def _patch_indices(origins: np.ndarray, img: int, seq: int):
    """Gather indices for a group of patches: (n, seq, 1, 1) time,
    (n, 1, img, 1) lat (reversed rows) and (n, 1, 1, img) lon."""
    sx, sy, k = origins[:, 0], origins[:, 1], origins[:, 2]
    ti = (k * seq)[:, None] + np.arange(seq)[None, :]
    yi = sy[:, None] + np.arange(img - 1, -1, -1)[None, :]
    xi = sx[:, None] + np.arange(img)[None, :]
    return (ti[:, :, None, None], yi[:, None, :, None],
            xi[:, None, None, :])


def make_tiled_predictor(mcfg: ModelConfig, icfg: InferenceConfig,
                         plan: TilingPlan, apply_fn: ApplyFn, device=None):
    """Build the single-device predictor for one tiling plan:
    ``run(field, generator) -> (prediction, counts)``.

    ``field``: (T, H, W, in_channels) float32 on ``device``, already merged
    (u10, v10, elevation/1e3) on the high-res grid.  ``prediction``:
    (T, H, W, out_channels) float32 with NaN where no patch contributed.
    ``generator``: the ``torch.Generator`` the noise is drawn from.
    ``apply_fn(patches, noise) -> preds`` runs the network: the generator
    module, or a stand-in that tests the tiling and stitch alone.  The
    origins, validity weights, coverage map and gather indices are built
    once here, on the host, and moved to ``device`` (``None`` means the
    card; see ``core.device.resolve_device``)."""
    device = resolve_device(device)
    img, seq, crop = plan.image_size, plan.sequence_length, icfg.border_crop
    origins_g, weights_np = _grouped_origins(plan, icfg.group_size)
    weights = torch.as_tensor(weights_np, device=device)
    coverage = torch.as_tensor(
        _coverage_counts(plan, origins_g, weights_np, crop), device=device)
    indices = [tuple(torch.as_tensor(ix, device=device)
                     for ix in _patch_indices(o, img, seq))
               for o in origins_g]
    reduce_axes = ((0, 1, 2) if icfg.replicate_normalization_quirk
                   else (0, 1, 2, 3))

    def gather_group(field, g):
        ti, yi, xi = indices[g]
        return field[ti, yi, xi]  # (group, seq, img, img, C)

    def stats_pass(field):
        """NaN-aware mean/std of the stacked patch tensor."""
        s = s2 = n = 0.0
        for g in range(len(indices)):
            patches = gather_group(field, g)
            nan = torch.isnan(patches)
            mask = (~nan).float() * weights[g][:, None, None, None, None]
            vals = torch.where(nan, torch.zeros_like(patches), patches)
            s = s + torch.sum(vals * mask, dim=reduce_axes)
            s2 = s2 + torch.sum(vals * vals * mask, dim=reduce_axes)
            n = n + torch.sum(mask, dim=reduce_axes)
        mean = s / torch.clamp(n, min=1.0)
        var = torch.clamp(s2 / torch.clamp(n, min=1.0) - mean ** 2, min=0.0)
        std = torch.sqrt(var)
        return mean, torch.where(std == 0, torch.ones_like(std), std)

    @torch.no_grad()
    def run(field: torch.Tensor, generator: torch.Generator
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        t_total, h, w, _ = field.shape
        mean, std = stats_pass(field)
        counts = coverage
        if counts.shape[0] < t_total:
            counts = torch.cat([counts, counts.new_zeros(
                (t_total - counts.shape[0],) + tuple(counts.shape[1:]))])
        counts = counts[:t_total]
        canvas = field.new_zeros((t_total, h, w, mcfg.out_channels))
        noise_shape = (icfg.group_size, seq, img, img, mcfg.noise_channels)
        for g, origins in enumerate(origins_g):
            normalized = (gather_group(field, g) - mean) / std
            noise = icfg.noise_std * torch.randn(
                noise_shape, generator=generator, device=field.device)
            preds = apply_fn(normalized, noise)
            # Un-reverse rows, crop borders, weight out padded patches.
            preds = preds.flip(2)[:, :, crop:img - crop, crop:img - crop]
            preds = preds * weights[g][:, None, None, None, None]
            for i, (sx, sy, k) in enumerate(origins.tolist()):
                canvas[k * seq:(k + 1) * seq, sy + crop:sy + img - crop,
                       sx + crop:sx + img - crop] += preds[i]
        out = torch.where(counts > 0, canvas / torch.clamp(counts, min=1.0),
                          torch.full_like(canvas, float("nan")))
        return out, counts[..., 0]

    return run
