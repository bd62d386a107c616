"""Host-streaming tiled inference (counterpart of
``windtpu/infer/streaming.py``): the capacity path for domains too large
for the monolithic engine's device-resident field and canvas.

* the field, the canvases and the coverage map live in host memory;
* only one or two fixed-shape patch groups (group_size, T_seq, img, img,
  C) are on the device at a time, so device memory does not grow with the
  domain;
* statistics, patch extraction, border crop and stitching repeat the
  monolithic engine's arithmetic (``infer/engine.py``): same grouping,
  same per-group noise draws from each member's ``torch.Generator``, same
  lat-reversed rows, same clamped slice starts, so a streamed run matches
  the monolithic one wherever both fit (the statistics here accumulate in
  fp64, the engine's in f32).

On the card two groups are in flight: group g's upload (page-locked
staging buffer, side stream, ordered before the forward by an event), its
forward and its download (``non_blocking`` into a page-locked buffer,
then an event) are enqueued before the host waits for group g-1's download
and stitches it.  A staging buffer is rewritten only after the event of
its previous transfer has fired.  Ensemble members share each group's one
upload and run as one batched forward.  ``streaming_transfer_dtype=
"bfloat16"`` halves both transfers; the host converts with torch (round to
nearest even, as the JAX package's ``ml_dtypes``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from windtpu_torch.core.config import InferenceConfig, ModelConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.infer.engine import (
    ApplyFn,
    Seed,
    _as_generator,
    _coverage_counts,
    _group_apply,
    _grouped_origins,
    _stitch_starts,
)
from windtpu_torch.infer.tiling import TilingPlan, plan_tiling
from windtpu_torch.utils.logging import span


def _clamped_start(start: int, size: int, dim: int) -> int:
    """jax.lax.dynamic_slice start-index clamping: slices never run out of
    bounds, they shift back instead.  The engine inherits this from XLA;
    the host path must reproduce it for plans whose covered window exceeds
    the field (numpy slicing would silently truncate, then the stitch
    would broadcast-crash)."""
    return max(0, min(start, dim - size))


def _host_patch(field: np.ndarray, origin, seq: int, img: int) -> np.ndarray:
    sx, sy, k = int(origin[0]), int(origin[1]), int(origin[2])
    t0 = _clamped_start(k * seq, seq, field.shape[0])
    y0 = _clamped_start(sy, img, field.shape[1])
    x0 = _clamped_start(sx, img, field.shape[2])
    patch = field[t0:t0 + seq, y0:y0 + img, x0:x0 + img]
    return patch[:, ::-1, :, :]                  # lat-reversed (api.py:119)


def _host_stats(field: np.ndarray, origins: np.ndarray, weights: np.ndarray,
                seq: int, img: int, quirk: bool):
    """nan-aware mean/std over all patches — the engine's stats_pass on
    the host, computed from per-time-slab integral images.

    The statistics reduce each patch over (time, lat) [quirk: per-(lon,
    channel)] or (time, lat, lon) [per-channel], and every patch with
    the same time index k shares one field slab — so instead of
    re-extracting every overlapping patch (a second full-domain sweep,
    the r4 streaming bench's single largest host cost), accumulate each
    slab's nan-masked (sum, sum-of-squares, count) over time, take one
    cumulative sum along lat, and read each patch's column sums with
    two O(img x C) lookups.  Same fp64 accumulation, same clamping,
    bit-equal reductions up to summation order."""
    t_total, h, w_pix, c = field.shape
    shape = (img, c) if quirk else (c,)
    s = np.zeros(shape, np.float64)
    s2 = np.zeros(shape, np.float64)
    n = np.zeros(shape, np.float64)
    by_k = {}
    for o, w in zip(origins.reshape(-1, 3), weights.ravel()):
        if w:
            by_k.setdefault(int(o[2]), []).append(
                (int(o[0]), int(o[1]), float(w)))
    for k, plist in sorted(by_k.items()):
        t0 = _clamped_start(k * seq, seq, t_total)
        # Accumulate the slab frame by frame (fp64) so transients stay
        # one (H, W, C) frame, not seq of them — the streaming engine's
        # memory contract is O(domain slice), never O(patch stack).
        a = np.zeros((h, w_pix, c), np.float64)
        a2 = np.zeros((h, w_pix, c), np.float64)
        m = np.zeros((h, w_pix, c), np.float64)
        for t in range(t0, t0 + seq):
            frame = field[t]
            msk = ~np.isnan(frame)
            v = np.where(msk, frame, 0.0).astype(np.float64)
            a += v
            a2 += v * v
            m += msk
        # Inclusive cumsum along lat, in place; a patch's column sums
        # over rows [y0, y0+img) are cum[y0+img-1] - cum[y0-1].
        np.cumsum(a, axis=0, out=a)
        np.cumsum(a2, axis=0, out=a2)
        np.cumsum(m, axis=0, out=m)
        for sx, sy, w in plist:
            y0 = _clamped_start(sy, img, h)
            x0 = _clamped_start(sx, img, w_pix)
            hi = y0 + img - 1
            if y0 == 0:
                col_a = a[hi, x0:x0 + img]
                col_a2 = a2[hi, x0:x0 + img]
                col_m = m[hi, x0:x0 + img]
            else:
                col_a = a[hi, x0:x0 + img] - a[y0 - 1, x0:x0 + img]
                col_a2 = a2[hi, x0:x0 + img] - a2[y0 - 1, x0:x0 + img]
                col_m = m[hi, x0:x0 + img] - m[y0 - 1, x0:x0 + img]
            if quirk:
                s += w * col_a
                s2 += w * col_a2
                n += w * col_m
            else:
                s += w * col_a.sum(axis=0)
                s2 += w * col_a2.sum(axis=0)
                n += w * col_m.sum(axis=0)
    mean = s / np.maximum(n, 1.0)
    var = np.maximum(s2 / np.maximum(n, 1.0) - mean**2, 0.0)
    std = np.sqrt(var)
    std = np.where(std == 0, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


class _Staging:
    """Two staging slots, a host buffer and an event each.  On the card
    the buffers are page-locked and the events are CUDA events; on the CPU
    there is nothing to wait for."""

    def __init__(self, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        self.buffers = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                        for _ in range(2)]
        self.events = [torch.cuda.Event() if self.cuda else None
                       for _ in range(2)]

    def record(self, slot: int, stream=None) -> None:
        if self.cuda:
            self.events[slot].record(stream)

    def wait(self, slot: int) -> None:
        """Block the host until the slot's last transfer has finished."""
        if self.cuda:
            self.events[slot].synchronize()


def downscale_field_streaming(
    apply_fn: ApplyFn,
    field: np.ndarray,               # (T, H, W, in_channels), HOST array
    mcfg: ModelConfig,
    icfg: Optional[InferenceConfig] = None,
    generator: Optional[Seed] = None,
    plan: Optional[TilingPlan] = None,
    ensemble_generators: Optional[Sequence[Seed]] = None,
    device=None,
) -> Tuple[np.ndarray, TilingPlan]:
    """Tile + predict + stitch with O(group) device memory.

    Same contract as :func:`windtpu_torch.infer.engine.downscale_field`,
    but the field stays a numpy array and the (T, H, W, out_channels)
    result is assembled in host memory; pixels no patch covers are NaN.
    ``generator``/``ensemble_generators`` are ``torch.Generator``s on
    ``device`` or int seeds.  With ``ensemble_generators`` the result
    gains a leading member axis; the statistics and coverage map are
    member-independent and computed once, and each group is uploaded once
    for all members."""
    device = resolve_device(device)
    icfg = icfg or InferenceConfig(
        sequence_length=mcfg.sequence_length, image_size=mcfg.image_size,
        noise_channels=mcfg.noise_channels)
    field = np.asarray(field, np.float32)
    t_total, h, w_pix, c_in = field.shape
    if plan is None:
        plan = plan_tiling(h, w_pix, t_total, icfg.image_size,
                           icfg.sequence_length, icfg.overlap_factor)
    seq, img, crop = plan.sequence_length, plan.image_size, icfg.border_crop
    size = img - 2 * crop
    group = icfg.group_size
    members = ensemble_generators is not None
    gens = [_as_generator(g, device) for g in (
        ensemble_generators if members
        else [0 if generator is None else generator])]
    n_members = len(gens)

    origins_g, weights_g = _grouped_origins(plan, group)
    counts = _coverage_counts(plan, origins_g, weights_g, crop)
    if counts.shape[0] < t_total:
        counts = np.concatenate(
            [counts, np.zeros((t_total - counts.shape[0],) + counts.shape[1:],
                              np.float32)], axis=0)
    elif counts.shape[0] > t_total:
        counts = counts[:t_total]  # engine trims the same way (engine.py)
    with span("engine.stats"):
        mean, std = _host_stats(field, origins_g, weights_g, seq, img,
                                icfg.replicate_normalization_quirk)
    weights_dev = torch.as_tensor(weights_g, device=device)
    canvases = np.zeros(
        (n_members, t_total, h, w_pix, mcfg.out_channels), np.float32)

    dtype = (torch.bfloat16 if icfg.streaming_transfer_dtype == "bfloat16"
             else torch.float32)
    up = _Staging((group, seq, img, img, c_in), dtype, device)
    down = _Staging((n_members, group, seq, size, size, mcfg.out_channels),
                    dtype, device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def dispatch(g: int) -> None:
        """Stage group g, then enqueue its upload, forward and download."""
        slot = g % 2
        patches = np.stack([_host_patch(field, o, seq, img)
                            for o in origins_g[g]])
        normalized = torch.from_numpy((patches - mean) / std)
        up.wait(slot)                 # the upload of group g-2 has finished
        host_in = up.buffers[slot]
        host_in.copy_(normalized)     # f32 -> bf16 rounds to nearest even
        if cuda:
            main = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                dev_in = host_in.to(device, non_blocking=True)
                up.record(slot, copy_stream)
            main.wait_event(up.events[slot])
            dev_in.record_stream(main)
        else:
            dev_in = host_in
        preds = _group_apply(apply_fn, dev_in, weights_dev[g], gens, mcfg,
                             icfg).to(dtype)
        # Group g-2's download from this slot was stitched before group g-1
        # was dispatched, so the slot is free.
        down.buffers[slot].copy_(preds, non_blocking=cuda)
        down.record(slot)

    def stitch(g: int) -> None:
        slot = g % 2
        down.wait(slot)
        preds = down.buffers[slot].float().numpy()
        starts = _stitch_starts(origins_g[g], seq, img, crop,
                                (t_total, h, w_pix))
        for i, (t0, y0, x0) in enumerate(starts.tolist()):
            if weights_g[g, i]:
                canvases[:, t0:t0 + seq, y0:y0 + size,
                         x0:x0 + size] += preds[:, i]

    with torch.no_grad():
        for g in range(origins_g.shape[0]):
            with span("engine.group"):
                dispatch(g)
            if g > 0:
                stitch(g - 1)         # while group g computes
        stitch(origins_g.shape[0] - 1)
    with span("engine.overlap_mean"):
        out = np.where(counts[None] > 0,
                       canvases / np.maximum(counts[None], 1.0), np.nan)
    return (out if members else out[0]), plan

