"""Inference API: ERA5 + DEM -> downscaled 1-km wind fields, in PyTorch.

Counterpart of ``windtpu/api.py``: ``downscale`` / ``predict`` /
``get_network`` on :mod:`windtpu_torch.io` datasets, running the
single-device tiled engine (:mod:`windtpu_torch.infer.engine`) and the
texture gate on the card.  Every entry point takes ``device=None``, which
means ``"cuda"`` and raises when no card is present; pass ``device="cpu"``
to run on the CPU.  Streaming and ensembles are later slices of the port
(ROADMAP.md, queue A item 6).
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
from windtpu_torch.infer.engine import make_tiled_predictor
from windtpu_torch.infer.template import (
    build_high_res_template_from_era5,
    process_era5,
    process_topo,
)
from windtpu_torch.infer.tiling import plan_tiling
from windtpu_torch.io.dataset import DataArray, Dataset

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

_LATER_SLICE = "ROADMAP.md queue A item 6 (streaming + ensembles)"


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
) -> Dataset:
    """Tile the merged (u10, v10, elevation) field into patch cubes, run the
    generator with fresh noise, stitch with an overlap mean and apply the
    texture gate, all on ``device``.

    ``seed`` seeds the ``torch.Generator`` the noise is drawn from, one
    draw per patch group in group order.  ``noise_std`` overrides the
    shipped 0.1; 0.0 makes the result deterministic.  ``streaming``:
    "auto" and False run the on-device engine; True raises
    (not yet ported).  ``texture_gate``: "auto"/True use the network's
    calibration, False disables the gate, a dict or ``.npz`` path
    overrides it."""
    dev = resolve_device(device)
    if streaming is True:
        raise NotImplementedError(
            f"streaming inference is not ported yet: {_LATER_SLICE}")
    if ensemble_members > 1:
        raise NotImplementedError(
            f"ensemble inference is not ported yet: {_LATER_SLICE}")
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
        gate_target = np.exp(predict_log_energy_np(
            gate_params, field)).astype(np.float32)
        gate_floor = np.asarray(gate_params["floor"], np.float32)

    t_total, h, w = field.shape[:3]
    plan = plan_tiling(h, w, t_total, icfg.image_size, icfg.sequence_length,
                       overlap_factor)
    print(f"Applying model to {plan.num_patches} patches")
    predictor = make_tiled_predictor(mcfg, icfg, plan, network.generator,
                                     dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pred, _ = predictor(torch.as_tensor(field, device=dev), gen)
    pred = _trim_canvas(pred, plan, icfg)
    if gate_params is not None:
        from windtpu_torch.models.texture_gate import apply_gate_targeted

        pred = apply_gate_targeted(torch.as_tensor(gate_target, device=dev),
                                   torch.as_tensor(gate_floor, device=dev),
                                   pred)
    pred = pred.cpu().numpy()
    return _assemble_output(pred, plan, icfg, time_vals, lat, lon)


def _trim_canvas(pred, plan, icfg):
    """Slice the stitched canvas to the covered time window and drop the
    border-cropped rim, so the gate runs on a field without NaN frames."""
    covered_t = plan.num_time_chunks * icfg.sequence_length
    pred = pred[:covered_t]
    b = icfg.border_crop
    if b:
        pred = pred[..., b:-b, b:-b, :]
    return pred


def _assemble_output(pred, plan, icfg, time_vals, lat, lon) -> Dataset:
    """Trimmed canvas (:func:`_trim_canvas`) -> output Dataset."""
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
    template = build_high_res_template_from_era5(
        era5, range_lon=range_lon, range_lat=range_lat)
    inputs_era5 = process_era5(era5, template)
    inputs_topo = process_topo(raster_topo, template)
    return predict(inputs_era5, inputs_topo, template,
                   overlap_factor=overlap_factor, network=network,
                   device=device, **predict_kwargs)
