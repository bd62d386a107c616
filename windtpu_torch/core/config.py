"""Typed configuration, field for field the same as ``windtpu/core/config.py``.

Plain frozen dataclasses with the JAX package's fields and defaults, so a
configuration reads the same on both sides and the tests can build one
from the other.  Fields that only steer the JAX programs (scan unrolling,
remat, the streaming transfer dtype) are kept for that parity; the port's
inference path reads the model and inference fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the generator/discriminator pair (shipped network:
    T=24, 96 px, 3 inputs, 20 noise channels, 2 outputs, generator width
    128, discriminator width 16)."""

    image_size: int = 96
    in_channels: int = 3
    noise_channels: int = 20
    out_channels: int = 2
    sequence_length: int = 24
    generator_features: int = 128
    discriminator_features: int = 16
    discriminator_shortcut_min_iters: int = 2
    # Computation dtype of the conv stack; parameters stay float32.
    compute_dtype: str = "float32"
    # Entry stem as conv(img) + conv(noise) with one sliced kernel.
    split_stem: bool = False
    critic_scan_unroll: int = 0
    critic_fused_branches: bool = False

    def __post_init__(self):
        if self.image_size % 4 != 0:
            raise ValueError("image_size must be a multiple of 4")
        if self.generator_features % 8 != 0:
            raise ValueError("generator_features must be a multiple of 8")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """WGAN-GP optimization schedule (used by the training slice)."""

    batch_size: int = 8
    n_critic: int = 3
    gp_weight: float = 100.0
    noise_std: float = 0.1
    g_learning_rate: float = 1e-4
    d_learning_rate: float = 4e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    adam_eps: float = 0.1
    optimizer: str = "adam"
    rmsprop_learning_rate: float = 5e-5
    reconstruction_coefficient: float = 0.0
    adversarial_coefficient: float = 1.0
    detach_gp: bool = False
    compute_metrics: bool = True
    remat: "bool | str" = False
    remat_gp: bool = False
    fused_scoring: bool = True
    compute_spatial_ks: bool = False
    sharpness_coefficient: float = 0.0
    sharpness_sigma: float = 7.0
    steps_per_call: int = 1
    steps_per_call_unroll: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Training data pipeline (used by the data slice)."""

    sequence_length: int = 6
    patch_size: int = 32
    batch_size: int = 16
    transform: bool = True
    input_variables: Tuple[str, ...] = (
        "u10", "v10", "blh", "fsr", "sp", "z", "vo", "d",
        "tpi_500", "ridge_index_norm",
    )
    output_variables: Tuple[str, ...] = ("U_10M", "V_10M")
    num_workers: int = 1


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Tiled inference."""

    sequence_length: int = 24
    image_size: int = 96
    batch_size: int = 8
    noise_channels: int = 20
    noise_std: float = 0.1
    overlap_factor: float = 0.05
    border_crop: int = 2
    # Patches per generator call.
    group_size: int = 16
    # True: per-(lon, channel) normalization statistics, as the reference
    # computes them; False: per-channel statistics.
    replicate_normalization_quirk: bool = True
    ensemble_members: int = 1
    scan_unroll: int = 4
    streaming_transfer_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GANConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    inference: InferenceConfig = dataclasses.field(
        default_factory=InferenceConfig)
    seed: int = 0
    checkpoint_dir: Optional[str] = None
