"""Tiled inference engine (counterpart of the predictors and
``downscale_field`` in ``windtpu/infer/engine.py``), on one device or
split over the ranks of a mesh (tile and ensemble parallelism).

The whole (T, H, W, C) field and the output canvas stay on the device:

  pass 1  over patch groups: NaN-aware sum / sum of squares of the
          stacked patch tensor -> normalization statistics;
  pass 2  over patch groups: gather patches, normalize, run the generator
          with fresh per-group noise, crop the 2-px border, and add the
          predictions into the canvas; finally divide by the host-computed
          coverage map (NaN where no patch lands).

Kept from the JAX engine: patches are fed lat-reversed and un-reversed on
output; ``replicate_normalization_quirk`` gives per-(lon, channel)
statistics with padded patches weighted out; ``std == 0 -> 1``; every
slice start is clamped into the field the way ``jax.lax.dynamic_slice``
and ``dynamic_update_slice`` clamp it, so a plan whose covered window runs
past the field shifts its patches back instead of failing.  Noise is one
draw per patch group, in group order, from the caller's
``torch.Generator``; it cannot reproduce JAX's ``fold_in`` streams.

Ensembles: ``run`` takes one generator per member.  Each group's
normalized patches are gathered once and go through one generator forward
over members x group patches; member ``m``'s noise comes from its own
generator with the one-member shape, so member ``m`` equals a one-member
run with that generator up to the batched forward's summation order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from windtpu_torch.core.config import InferenceConfig, ModelConfig
from windtpu_torch.core.device import resolve_device
from windtpu_torch.core.mesh import Mesh, all_reduce
from windtpu_torch.infer.tiling import TilingPlan, plan_tiling
from windtpu_torch.utils.logging import span

ApplyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Seed = Union[int, torch.Generator]


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


def _grouped_origins(plan: TilingPlan, group: int, group_multiple: int = 1):
    """(G, group, 3) int32 origins + (G, group) validity weights, with the
    group count padded to a multiple of ``group_multiple`` by zero-weight
    groups."""
    origins_np, weights_np = _pad_to_multiple(
        plan.patch_origins().astype(np.int32), group)
    origins_g = origins_np.reshape(-1, group, 3)
    weights_g = weights_np.reshape(-1, group)
    if group_multiple > 1:
        pad = (-origins_g.shape[0]) % group_multiple
        if pad:
            origins_g = np.concatenate(
                [origins_g, np.repeat(origins_g[-1:], pad, axis=0)], axis=0)
            weights_g = np.concatenate(
                [weights_g, np.zeros((pad, group), np.float32)], axis=0)
    return origins_g, weights_g


def _clamp(start: np.ndarray, size: int, dim: int) -> np.ndarray:
    """``dynamic_slice`` start clamping: a slice of ``size`` along a ``dim``
    long axis starts in [0, dim - size]."""
    return np.clip(start, 0, max(dim - size, 0))


def _patch_indices(origins: np.ndarray, img: int, seq: int,
                   shape: Tuple[int, int, int]):
    """Gather indices for a group of patches of a (T, H, W, C) field of
    ``shape`` (T, H, W): (n, seq, 1, 1) time, (n, 1, img, 1) lat (reversed
    rows) and (n, 1, 1, img) lon, each start clamped into the field."""
    t_total, h, w = shape
    t0 = _clamp(origins[:, 2] * seq, seq, t_total)
    y0 = _clamp(origins[:, 1], img, h)
    x0 = _clamp(origins[:, 0], img, w)
    ti = t0[:, None] + np.arange(seq)[None, :]
    yi = y0[:, None] + np.arange(img - 1, -1, -1)[None, :]
    xi = x0[:, None] + np.arange(img)[None, :]
    return (ti[:, :, None, None], yi[:, None, :, None],
            xi[:, None, None, :])


def _stitch_starts(origins: np.ndarray, seq: int, img: int, crop: int,
                   shape: Tuple[int, int, int]) -> np.ndarray:
    """(n, 3) canvas starts (t, y, x) of the cropped updates.  The CROPPED
    update (size = img - 2*crop) is clamped against the canvas, as the JAX
    engine's ``dynamic_update_slice`` does; for h - img < sy <= h - img +
    crop that differs from clamping the patch start and adding ``crop``."""
    t_total, h, w = shape
    size = img - 2 * crop
    return np.stack([_clamp(origins[:, 2] * seq, seq, t_total),
                     _clamp(origins[:, 1] + crop, size, h),
                     _clamp(origins[:, 0] + crop, size, w)], axis=1)


def _group_apply(apply_fn: ApplyFn, patches: torch.Tensor,
                 weights: torch.Tensor, generators: Sequence[torch.Generator],
                 mcfg: ModelConfig, icfg: InferenceConfig) -> torch.Tensor:
    """One group of normalized, lat-reversed patches -> (M, group, seq,
    size, size, out_channels) cropped, validity-weighted predictions, one
    row per member; both engines call it.

    The patches are upcast to f32; member ``m``'s noise is drawn on the
    patches' device from ``generators[m]`` with the one-member shape; the
    members run as one batched forward."""
    img, crop = patches.shape[2], icfg.border_crop
    n_members = len(generators)
    patches = patches.float()
    noise_shape = tuple(patches.shape[:-1]) + (mcfg.noise_channels,)
    noise = torch.cat([icfg.noise_std * torch.randn(
        noise_shape, generator=gen, device=patches.device)
        for gen in generators])
    if n_members > 1:
        patches = patches.repeat(n_members, 1, 1, 1, 1)
    preds = apply_fn(patches, noise)
    # Un-reverse rows, crop borders, weight out padded patches.
    preds = preds.flip(2)[:, :, crop:img - crop, crop:img - crop]
    preds = preds.reshape((n_members, -1) + tuple(preds.shape[1:]))
    return preds * weights[None, :, None, None, None, None]


def _as_generator(g: Seed, device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``; an int is its seed."""
    if isinstance(g, torch.Generator):
        return g
    return torch.Generator(device=device).manual_seed(int(g))


def make_tiled_predictor(mcfg: ModelConfig, icfg: InferenceConfig,
                         plan: TilingPlan, apply_fn: ApplyFn, device=None):
    """Build the single-device predictor for one tiling plan:
    ``run(field, generator) -> (prediction, counts)``.

    ``field``: (T, H, W, in_channels) float32 on ``device``, already merged
    (u10, v10, elevation/1e3) on the high-res grid.  ``prediction``:
    (T, H, W, out_channels) float32 with NaN where no patch contributed.
    ``generator``: the ``torch.Generator`` the noise is drawn from, or a
    sequence of them, one per ensemble member; then ``prediction`` is
    (M, T, H, W, out_channels).  ``apply_fn(patches, noise) -> preds`` runs
    the network: the generator module, or a stand-in that tests the tiling
    and stitch alone.  The origins, validity weights and coverage map are
    built once here, on the host, and moved to ``device`` (``None`` means
    the card; see ``core.device.resolve_device``)."""
    return _build_predictor(mcfg, icfg, plan, apply_fn, device)


def make_tile_parallel_predictor(mcfg: ModelConfig, icfg: InferenceConfig,
                                 plan: TilingPlan, mesh: Mesh,
                                 apply_fn: ApplyFn, axis: str = "data",
                                 device=None):
    """Spatial-tile parallel inference over the ranks of ``mesh``'s
    ``axis``: the same ``run(field, generator) -> (prediction, counts)``
    as :func:`make_tiled_predictor`, called on every rank with the same
    field and generators, and the same result on every rank.

    The group list is padded with zero-weight groups to a multiple of the
    axis size, and each rank takes a contiguous block of it.  A rank sums
    the normalisation statistics over its own patches, and one all-reduce
    makes them global; it stitches its predictions into a local canvas,
    and one all-reduce of the canvas completes the overlap mean, whose
    coverage map comes from the global origin list.  The noise equals the
    single-device predictor's: a rank whose block starts at group ``g0``
    draws and drops the noise of groups ``0 .. g0 - 1`` from each
    generator first (one group-sized draw at a time, the draws the
    single-device run makes), so each group sees the numbers it sees
    there."""
    return _build_predictor(mcfg, icfg, plan, apply_fn, device,
                            mesh.axis_size(axis), mesh.axis_index(axis),
                            mesh.group(axis))


def make_ensemble_tile_parallel_predictor(
        mcfg: ModelConfig, icfg: InferenceConfig, plan: TilingPlan,
        mesh: Mesh, apply_fn: ApplyFn, tile_axis: str = "data",
        ensemble_axis: str = "ensemble", device=None):
    """Ensemble and tile parallelism together: ``run(field, generators) ->
    (prediction (M, T, H, W, out_channels), counts)`` with one generator
    per member, the same on every rank.  The members split over
    ``ensemble_axis`` in contiguous blocks (M divisible by its size), and
    each member's patch groups over ``tile_axis`` as in
    :func:`make_tile_parallel_predictor` (an absent axis has size 1).
    Generator work is members x patches, split over the whole mesh.  One
    all-reduce over ``ensemble_axis`` into a zero-filled (M, ...) canvas
    leaves every member on every rank."""
    tiled = make_tile_parallel_predictor(mcfg, icfg, plan, mesh, apply_fn,
                                         tile_axis, device)
    n_ens = mesh.axis_size(ensemble_axis)
    e = mesh.axis_index(ensemble_axis)

    @torch.no_grad()
    def run(field: torch.Tensor, generators: Sequence[torch.Generator]):
        n_members = len(generators)
        if n_members % n_ens:
            raise ValueError(f"{n_members} members do not split over the "
                             f"{n_ens} ranks of {ensemble_axis!r}")
        per = n_members // n_ens
        own, counts = tiled(field, list(generators[e * per:(e + 1) * per]))
        out = own.new_zeros((n_members,) + tuple(own.shape[1:]))
        out[e * per:(e + 1) * per] = own
        return all_reduce(out, mesh.group(ensemble_axis)), counts

    return run


def _skip_noise(gens: Sequence[torch.Generator], shape, groups: int,
                device: torch.device) -> None:
    """Advance each generator past ``groups`` group-sized noise draws,
    drawn one at a time as :func:`_group_apply` draws them."""
    if groups == 0:
        return
    buf = torch.empty(shape, device=device)
    for gen in gens:
        for _ in range(groups):
            torch.randn(shape, generator=gen, out=buf)


def _build_predictor(mcfg, icfg, plan, apply_fn, device, n_shards: int = 1,
                     shard: int = 0, group=None):
    """The predictor of :func:`make_tiled_predictor` on block ``shard`` of
    ``n_shards`` of the group list, its statistics and canvas summed over
    the process group ``group`` (None: one device)."""
    device = resolve_device(device)
    img, seq, crop = plan.image_size, plan.sequence_length, icfg.border_crop
    size = img - 2 * crop
    origins_g, weights_np = _grouped_origins(plan, icfg.group_size, n_shards)
    weights = torch.as_tensor(weights_np, device=device)
    # Coverage is a whole-domain quantity: from the global origin list.
    coverage = torch.as_tensor(
        _coverage_counts(plan, origins_g, weights_np, crop), device=device)
    per = origins_g.shape[0] // n_shards
    own = range(shard * per, (shard + 1) * per)
    noise_shape = (icfg.group_size, seq, img, img, mcfg.noise_channels)
    reduce_axes = ((0, 1, 2) if icfg.replicate_normalization_quirk
                   else (0, 1, 2, 3))
    plans_by_shape = {}

    def field_plan(shape):
        """Per field shape: each own group's index, gather indices on the
        device and stitch starts on the host."""
        if shape not in plans_by_shape:
            plans_by_shape[shape] = [
                (g, tuple(torch.as_tensor(ix, device=device)
                          for ix in _patch_indices(origins_g[g], img, seq,
                                                   shape)),
                 _stitch_starts(origins_g[g], seq, img, crop,
                                shape).tolist())
                for g in own]
        return plans_by_shape[shape]

    def stats_pass(field, groups):
        """NaN-aware mean/std of the stacked patch tensor."""
        s = s2 = n = 0.0
        for g, ix, _ in groups:
            patches = field[ix]
            nan = torch.isnan(patches)
            mask = (~nan).float() * weights[g][:, None, None, None, None]
            vals = torch.where(nan, torch.zeros_like(patches), patches)
            s = s + torch.sum(vals * mask, dim=reduce_axes)
            s2 = s2 + torch.sum(vals * vals * mask, dim=reduce_axes)
            n = n + torch.sum(mask, dim=reduce_axes)
        if group is not None:
            s, s2, n = all_reduce(torch.stack([s, s2, n]), group)
        mean = s / torch.clamp(n, min=1.0)
        var = torch.clamp(s2 / torch.clamp(n, min=1.0) - mean ** 2, min=0.0)
        std = torch.sqrt(var)
        return mean, torch.where(std == 0, torch.ones_like(std), std)

    @torch.no_grad()
    def run(field: torch.Tensor,
            generator: Union[torch.Generator, Sequence[torch.Generator]]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        members = isinstance(generator, (list, tuple))
        gens = list(generator) if members else [generator]
        n_members = len(gens)
        t_total, h, w, _ = field.shape
        groups = field_plan((t_total, h, w))
        with span("engine.stats"):
            mean, std = stats_pass(field, groups)
        counts = coverage
        if counts.shape[0] < t_total:
            counts = torch.cat([counts, counts.new_zeros(
                (t_total - counts.shape[0],) + tuple(counts.shape[1:]))])
        counts = counts[:t_total]
        canvas = field.new_zeros((n_members, t_total, h, w,
                                  mcfg.out_channels))
        _skip_noise(gens, noise_shape, own.start, field.device)
        for g, ix, starts in groups:
            with span("engine.group"):
                preds = _group_apply(apply_fn, (field[ix] - mean) / std,
                                     weights[g], gens, mcfg, icfg)
                for i, (t0, y0, x0) in enumerate(starts):
                    canvas[:, t0:t0 + seq, y0:y0 + size,
                           x0:x0 + size] += preds[:, i]
        with span("engine.overlap_mean"):
            all_reduce(canvas, group)
            # In place: the overlap mean adds no canvas-sized temporary.
            out = canvas.div_(torch.clamp(counts, min=1.0)).masked_fill_(
                counts == 0, float("nan"))
        return (out if members else out[0]), counts[..., 0]

    return run


def downscale_field(
    apply_fn: ApplyFn,
    field,                           # (T, H, W, in_channels)
    mcfg: ModelConfig,
    icfg: Optional[InferenceConfig] = None,
    generator: Optional[Seed] = None,
    plan: Optional[TilingPlan] = None,
    ensemble_generators: Optional[Sequence[Seed]] = None,
    device=None,
    mesh: Optional[Mesh] = None,
    tile_axis: str = "data",
) -> Tuple[torch.Tensor, TilingPlan]:
    """Tile + predict + stitch a full field.  Returns (prediction, plan).

    ``field`` is a tensor or a numpy array, moved to ``device`` (``None``
    means the card).  ``generator`` is a ``torch.Generator`` or an int
    seed (default seed 0).  With ``ensemble_generators`` (generators or
    seeds, one per member) the result gains a leading member axis: the
    members share each group's gather and run as one batched forward.

    With ``mesh`` every rank calls this with the same arguments and gets
    the same result: members split over an ``ensemble`` axis when the mesh
    has one that divides them (:func:`make_ensemble_tile_parallel_
    predictor`), else patch groups split over ``tile_axis``
    (:func:`make_tile_parallel_predictor`), as the JAX package routes."""
    device = resolve_device(device)
    icfg = icfg or InferenceConfig(
        sequence_length=mcfg.sequence_length, image_size=mcfg.image_size,
        noise_channels=mcfg.noise_channels)
    with span("engine.plan"):
        field = torch.as_tensor(field, dtype=torch.float32, device=device)
        t, h, w, _ = field.shape
        if plan is None:
            plan = plan_tiling(h, w, t, icfg.image_size,
                               icfg.sequence_length, icfg.overlap_factor)
        if ensemble_generators is not None:
            gens = [_as_generator(g, device) for g in ensemble_generators]
        else:
            gens = _as_generator(0 if generator is None else generator,
                                 device)
        if (ensemble_generators is not None and mesh is not None
                and "ensemble" in mesh.axis_names
                and len(gens) % mesh.axis_size("ensemble") == 0):
            predictor = make_ensemble_tile_parallel_predictor(
                mcfg, icfg, plan, mesh, apply_fn, tile_axis, "ensemble",
                device)
        elif mesh is not None:
            predictor = make_tile_parallel_predictor(
                mcfg, icfg, plan, mesh, apply_fn, tile_axis, device)
        else:
            predictor = make_tiled_predictor(mcfg, icfg, plan, apply_fn,
                                             device)
    return predictor(field, gens)[0], plan
