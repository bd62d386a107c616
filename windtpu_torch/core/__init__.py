from windtpu_torch.core.config import (  # noqa: F401
    DataConfig,
    GANConfig,
    InferenceConfig,
    ModelConfig,
    TrainConfig,
)
from windtpu_torch.core.device import resolve_device  # noqa: F401
