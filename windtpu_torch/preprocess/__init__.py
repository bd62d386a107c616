from windtpu_torch.preprocess.topo import process_topographic_variables_file  # noqa: F401
from windtpu_torch.preprocess.daily import (  # noqa: F401
    compute_time_varying_topo_pred,
    compute_wind_speed_and_angle,
    process_imgs,
    process_imgs_cosmoblurred,
)
