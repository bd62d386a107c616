from windtpu_torch.utils.logging import (MetricsLogger,  # noqa: F401
                                         profile_region)
