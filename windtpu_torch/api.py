"""Inference API: ERA5 + DEM -> downscaled 1-km wind fields, in PyTorch.

Counterpart of ``windtpu/api.py``: ``downscale`` / ``predict`` /
``get_network`` on :mod:`windtpu_torch.io` datasets, running the
tiled engine (:mod:`windtpu_torch.infer.engine`), or the host-streaming
engine (:mod:`windtpu_torch.infer.streaming`) for domains too large for
it, and the texture gate.  Ensembles run their members as one batched
forward per patch group.  In a multi-process run (one process per card,
:func:`windtpu_torch.parallel.initialize_distributed`) ``predict`` splits
the members and patch groups over an inference mesh
(:func:`inference_mesh`), and every rank returns the same result.  Every
entry point takes ``device=None``, which means ``"cuda"`` (this rank's
card) and raises when no card is present; pass ``device="cpu"`` to run on
the CPU.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from windtpu_torch.core.config import (GANConfig, InferenceConfig,
                                       ModelConfig, TrainConfig)
from windtpu_torch.core.device import resolve_device
from windtpu_torch.core.mesh import Mesh, make_mesh
from windtpu_torch.core.mesh import world as mesh_world
from windtpu_torch.infer.engine import downscale_field
from windtpu_torch.infer.template import (
    build_high_res_template_from_era5,
    process_era5,
    process_topo,
)
from windtpu_torch.infer.tiling import plan_tiling
from windtpu_torch.io.dataset import DataArray, Dataset
from windtpu_torch.utils.logging import span

# Shipped-model constants (the JAX package's api.py).
SEQUENCE_LENGTH = 24
IMG_SIZE = 96
BATCH_SIZE = 8
NOISE_CHANNELS = 20
NOISE_STD = 0.1
NB_INPUTS = 3
NB_OUTPUTS = 2

WEIGHTS_ENV = "WINDTPU_WEIGHTS"
# The bundled assets are read in place from the JAX package's directory.
ASSETS = Path(__file__).resolve().parents[1] / "windtpu" / "assets" / "weights"
BUNDLED_GENERATOR = ASSETS / "generator-synth.npz"
BUNDLED_GATE = ASSETS / "texture-gate.npz"

def flagship_config() -> GANConfig:
    """Shipped-model configuration, bfloat16 compute (parameters stay
    float32); set compute_dtype="float32" for tight comparisons."""
    return GANConfig(
        model=ModelConfig(
            image_size=IMG_SIZE, in_channels=NB_INPUTS,
            noise_channels=NOISE_CHANNELS, out_channels=NB_OUTPUTS,
            sequence_length=SEQUENCE_LENGTH, compute_dtype="bfloat16"),
        train=TrainConfig(batch_size=BATCH_SIZE, noise_std=NOISE_STD),
    )


def get_network(weights_path: Optional[str] = None, device=None):
    """Build the flagship generator on ``device`` and load weights.

    Resolution order: explicit argument, $WINDTPU_WEIGHTS, the bundled
    ``generator-synth.npz``, else random initialization with a warning.
    The bundled texture gate is attached when present."""
    from windtpu_torch.models.texture_gate import load_gate_npz
    from windtpu_torch.network import WindDownscalingGAN

    print("Loading network...")
    gan = WindDownscalingGAN(flagship_config(), device=device)
    weights = weights_path or os.environ.get(WEIGHTS_ENV) or (
        BUNDLED_GENERATOR if BUNDLED_GENERATOR.exists() else None)
    if weights:
        print(f"loading weights from {weights}")
        gan.load_weights(weights)
    else:
        print("warning: no pretrained weights found (set $WINDTPU_WEIGHTS); "
              "using random initialization")
    if BUNDLED_GATE.exists():
        gan.texture_gate = load_gate_npz(BUNDLED_GATE)
    return gan


def inference_mesh_axes(ensemble_members: int, n_ranks: int):
    """The axes of :func:`inference_mesh` over ``n_ranks`` ranks: the JAX
    package's factorisation rules, or None for one rank."""
    if n_ranks <= 1:
        return None
    e = 1
    if ensemble_members > 1:
        # The largest divisor of the member count that also divides the
        # ranks, so that data x ensemble uses every rank.
        e = max(d for d in range(1, n_ranks + 1)
                if ensemble_members % d == 0 and n_ranks % d == 0)
    axes = {}
    if n_ranks // e > 1:
        axes["data"] = n_ranks // e
    if e > 1:
        axes["ensemble"] = e
    return axes or None


def inference_mesh(ensemble_members: int = 1,
                   world: Optional[int] = None) -> Optional[Mesh]:
    """The inference mesh over the first ``world`` ranks (default:
    all of the process group): an ``ensemble`` axis of the largest divisor
    of the member count that fits (one member per rank), and the rest of
    the ranks on a ``data`` axis that splits the patch groups (tile
    parallelism).  None for one rank: the single-device engine needs no
    mesh.  Every rank must call it alike (the first call of a shape makes
    its process groups; later calls return that mesh)."""
    n = mesh_world()[1] if world is None else world
    axes = inference_mesh_axes(ensemble_members, n)
    return None if axes is None else make_mesh(axes)


# Diagnostics of the most recent predict(): which engine ran ("single",
# "tile", "ensemble", "ensemble+tile" or "streaming"), the mesh's axes,
# whether the members were split over ranks, how many ranks ran it, and
# whether the texture gate was applied.
_LAST_RUN = {}


def last_run_info() -> dict:
    """Diagnostics of the most recent :func:`predict`."""
    return dict(_LAST_RUN)


def _engine_hbm_bytes(t: int, h: int, w: int, in_ch: int,
                      out_ch: int, members_per_device: int = 1) -> int:
    """The monolithic engine's resident domain tensors, the JAX package's
    formula: field + (canvas + one canvas-sized buffer) per member +
    coverage map, all f32.  Every device ends with every member's canvas
    (on a mesh too), so the member count is the whole ensemble."""
    px = t * h * w
    return 4 * (px * in_ch + members_per_device * 2 * px * out_ch + px)


# Streaming kicks in when _engine_hbm_bytes exceeds this many bytes.
# Measured by chip_smoke.py's streaming path on an NVIDIA H100 80GB HBM3
# at 700.00 W: the monolithic engine plus the device texture gate peaked
# at 2.29, 9.15 and 30.52 GiB above the weights for estimates of 0.5, 3
# and 12 GiB (24 h square domains), 2.54x the estimate at 12 GiB; the fit
# 2.43 x estimate + 1.4 GiB reaches the card's 79.2 GiB at about 32 GiB.
# The default is the largest measured fit, 12 GiB: under 40% of the card.
# With 4 members at that threshold (2590 x 2590, 11.995 GiB, one 64-patch
# forward per group, the gate one member at a time) the peak was 19.06
# GiB, 1.59x the estimate.  chip_smoke.py measures all four points again
# on every run.  Override with WINDTPU_STREAMING_BYTES.
_STREAMING_DEFAULT_BYTES = 12 << 30


def _streaming_threshold() -> int:
    return int(os.environ.get("WINDTPU_STREAMING_BYTES",
                              _STREAMING_DEFAULT_BYTES))


def member_seeds(seed: int, members: int):
    """The seeds of an ensemble's members: ``numpy.random.SeedSequence(
    seed).generate_state(members, uint64)``, each masked to 63 bits.
    Member ``m`` of ``predict(seed=s, ensemble_members=M)`` equals
    ``predict(seed=member_seeds(s, M)[m])``, up to the batched forward's
    summation order."""
    state = np.random.SeedSequence(seed).generate_state(members, np.uint64)
    return [int(v) & ((1 << 63) - 1) for v in state]


def predict(
    inputs_era5: Dataset,
    inputs_topo: Dataset,
    high_res_template: Dataset,
    overlap_factor: float = 0.05,
    network=None,
    seed: int = 0,
    ensemble_members: int = 1,
    noise_std: Optional[float] = None,
    streaming="auto",
    texture_gate="auto",
    device=None,
    mesh="auto",
) -> Dataset:
    """Tile the merged (u10, v10, elevation) field into patch cubes, run the
    generator with fresh noise, stitch with an overlap mean and apply the
    texture gate.

    ``seed`` seeds the ``torch.Generator`` the noise is drawn from, one
    draw per patch group in group order.  With ``ensemble_members`` = M > 1
    the output gains a ``member`` axis and member ``m`` draws from the
    seed ``member_seeds(seed, M)[m]``.  The JAX package splits its key
    with ``jax.random.split``, which torch cannot reproduce: members match
    across the two packages only at ``noise_std=0``.  ``noise_std``
    overrides the shipped 0.1; 0.0 makes the result deterministic.

    ``streaming``: "auto" runs the host-streaming engine
    (:mod:`windtpu_torch.infer.streaming`: field and canvases in host
    memory, one or two patch groups on the device) when the monolithic
    engine's resident tensors (``_engine_hbm_bytes``, scaled by the member
    count) exceed ``_streaming_threshold()``; True forces it, False
    forbids it.  ``texture_gate``: "auto"/True use the network's
    calibration, False disables the gate, a dict or ``.npz`` path
    overrides it; it runs where the stitched canvas lives (on the device
    for the monolithic engine, in host memory for streaming).

    ``mesh``: "auto" builds :func:`inference_mesh` when a process group of
    more than one rank exists, else runs on one device; a
    :class:`windtpu_torch.core.mesh.Mesh` or None chooses.  On a mesh every
    rank calls ``predict`` alike, the members split over its ``ensemble``
    axis when it divides them and the patch groups over its ``data``
    axis, and every rank gates and returns the whole result.  Streaming
    runs on one device per rank, as in the JAX package.
    ``last_run_info()`` reports which engine ran and where."""
    dev = resolve_device(device)
    network = network if network is not None else get_network(device=dev)
    if network.device != dev:
        raise ValueError(f"the network lives on {network.device}, but "
                         f"predict was asked to run on {dev}")
    gate_params = None
    if texture_gate == "auto" or texture_gate is True:
        gate_params = network.texture_gate
    elif isinstance(texture_gate, (str, os.PathLike)):
        from windtpu_torch.models.texture_gate import load_gate_npz

        gate_params = load_gate_npz(texture_gate)
    elif texture_gate:
        gate_params = texture_gate
    mcfg = network.cfg.model
    icfg = InferenceConfig(
        sequence_length=mcfg.sequence_length, image_size=mcfg.image_size,
        noise_channels=mcfg.noise_channels,
        noise_std=NOISE_STD if noise_std is None else noise_std,
        overlap_factor=overlap_factor)

    time_vals = inputs_era5.coords["time"].values
    lat = inputs_era5.coords["lat_1"].values
    lon = inputs_era5.coords["lon_1"].values

    u10 = np.asarray(inputs_era5["u10"].values, np.float32)
    v10 = np.asarray(inputs_era5["v10"].values, np.float32)
    elev = np.asarray(inputs_topo["elevation"].values, np.float32) / 1e3
    elev_t = np.broadcast_to(elev, u10.shape)
    field = np.stack([u10, v10, elev_t], axis=-1)  # (T, lat, lon, 3)

    gate_target = gate_floor = None
    if gate_params is not None:
        from windtpu_torch.models.texture_gate import predict_log_energy_np

        # Host side: a dozen intensive statistics of the host-resident
        # input; only the two target energies go to the device.
        with span("predict.gate"):
            gate_target = np.exp(predict_log_energy_np(
                gate_params, field)).astype(np.float32)
        gate_floor = np.asarray(gate_params["floor"], np.float32)

    t_total, h, w = field.shape[:3]
    plan = plan_tiling(h, w, t_total, icfg.image_size, icfg.sequence_length,
                       overlap_factor)
    print(f"Applying model to {plan.num_patches} patches")
    member_axis = ensemble_members > 1
    seeds = member_seeds(seed, ensemble_members) if member_axis else [seed]
    if streaming == "auto":
        # Every rank ends with every member's canvas, so the whole
        # ensemble counts on each, as on one device.
        streaming = (_engine_hbm_bytes(t_total, h, w, mcfg.in_channels,
                                       mcfg.out_channels,
                                       members_per_device=ensemble_members)
                     > _streaming_threshold())
        if streaming:
            print("# domain exceeds the on-device engine's memory budget; "
                  "using the host-streaming engine")
    members = (dict(ensemble_generators=seeds) if member_axis
               else dict(generator=seed))
    if streaming:
        from windtpu_torch.infer.streaming import downscale_field_streaming

        with span("predict.engine"):
            pred, _ = downscale_field_streaming(
                network.generator, field, mcfg, icfg, plan=plan, device=dev,
                **members)
        pred = _trim_canvas(pred, plan, icfg)
        if gate_params is not None:
            from windtpu_torch.models.texture_gate import \
                apply_gate_targeted_np

            # The streamed canvas lives in host memory because it does not
            # fit on the device: gate it there, frame at a time.
            with span("predict.gate_apply"):
                pred = apply_gate_targeted_np(gate_target, gate_floor, pred)
        mode, mesh, ensemble_sharded = "streaming", None, False
    else:
        if isinstance(mesh, str) and mesh == "auto":
            mesh = inference_mesh(ensemble_members)
        ensemble_sharded = (member_axis and mesh is not None
                            and "ensemble" in mesh.axis_names
                            and ensemble_members
                            % mesh.axis_size("ensemble") == 0)
        with span("predict.engine"):
            pred, _ = downscale_field(network.generator, field, mcfg, icfg,
                                      plan=plan, device=dev, mesh=mesh,
                                      **members)
        pred = _trim_canvas(pred, plan, icfg)
        if gate_params is not None:
            # On the whole canvas of every rank, after the all-reduces.
            with span("predict.gate_apply"):
                _gate_members_on_device(
                    torch.as_tensor(gate_target, device=dev),
                    torch.as_tensor(gate_floor, device=dev), pred,
                    member_axis)
        with span("predict.readback"):
            pred = pred.cpu().numpy()
        tile_parallel = mesh is not None and mesh.axis_size("data") > 1
        mode = (("ensemble" if member_axis else "tile" if tile_parallel
                 else "single")
                + ("+tile" if member_axis and tile_parallel else ""))
    _LAST_RUN.clear()
    _LAST_RUN.update(
        mode=mode, mesh_axes=None if mesh is None else mesh.shape,
        ensemble_sharded=ensemble_sharded,
        n_devices=1 if mesh is None else mesh.size,
        texture_gate=gate_params is not None)
    with span("predict.assemble"):
        return _assemble_output(pred, member_axis, plan, icfg, time_vals,
                                lat, lon, ensemble_members)


def _gate_members_on_device(target, floor, pred, member_axis: bool) -> None:
    """Apply the texture gate to the trimmed device canvas ``pred`` in
    place, one member at a time.  The gate's FFT buffers are several
    canvases large: gating 4 members at once at the default threshold
    (a 24 h 2590 x 2590 domain) peaked above half of an NVIDIA H100 80GB
    HBM3 (700 W), which one member at a time avoids."""
    from windtpu_torch.models.texture_gate import apply_gate_targeted

    for member in (pred if member_axis else pred[None]):
        member.copy_(apply_gate_targeted(target, floor, member))


def _trim_canvas(pred, plan, icfg):
    """Slice the stitched canvas (..., T, H, W, C) to the covered time
    window and drop the border-cropped rim, so the gate runs on a field
    without NaN frames."""
    covered_t = plan.num_time_chunks * icfg.sequence_length
    pred = pred[..., :covered_t, :, :, :]
    b = icfg.border_crop
    if b:
        pred = pred[..., b:-b, b:-b, :]
    return pred


def _assemble_output(pred, member_axis, plan, icfg, time_vals, lat, lon,
                     ensemble_members) -> Dataset:
    """Trimmed canvas (:func:`_trim_canvas`) -> output Dataset, with a
    leading ``member`` axis for an ensemble."""
    covered_t = plan.num_time_chunks * icfg.sequence_length
    b = icfg.border_crop
    if b:
        lat = lat[b:-b]
        lon = lon[b:-b]
    coords = {
        "time": DataArray(("time",), time_vals[:covered_t]),
        "lat_1": DataArray(("lat_1",), lat),
        "lon_1": DataArray(("lon_1",), lon),
    }
    dims = ("time", "lat_1", "lon_1")
    if member_axis:
        coords["member"] = DataArray(
            ("member",), np.arange(ensemble_members))
        dims = ("member",) + dims
    data_vars = {
        "u10": DataArray(dims, pred[..., 0]),
        "v10": DataArray(dims, pred[..., 1]),
    }
    return Dataset(data_vars, coords)


def downscale(
    era5: Dataset,
    raster_topo: Dataset,
    range_lon: Optional[Tuple[float, float]] = None,
    range_lat: Optional[Tuple[float, float]] = None,
    overlap_factor: float = 0.05,
    network=None,
    device=None,
    **predict_kwargs,
) -> Dataset:
    """ERA5 dataset + DEM raster + bbox -> downscaled dataset.  Extra
    keyword arguments reach :func:`predict`."""
    with span("downscale"):
        with span("downscale.template"):
            template = build_high_res_template_from_era5(
                era5, range_lon=range_lon, range_lat=range_lat)
            inputs_era5 = process_era5(era5, template)
            inputs_topo = process_topo(raster_topo, template)
        return predict(inputs_era5, inputs_topo, template,
                       overlap_factor=overlap_factor, network=network,
                       device=device, **predict_kwargs)
