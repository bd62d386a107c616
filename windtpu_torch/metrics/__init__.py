from windtpu_torch.metrics.metrics import (  # noqa: F401
    angular_cosine_distance,
    extreme_weighted_rmse,
    log_spectral_distance,
    opposite_cosine_similarity,
    spatially_convolved_ks_stat,
    wind_speed_rmse,
    wind_speed_weighted_rmse,
)
