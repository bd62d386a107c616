from windtpu_torch.infer.tiling import TilingPlan, plan_tiling  # noqa: F401
from windtpu_torch.infer.engine import downscale_field, make_tiled_predictor  # noqa: F401
from windtpu_torch.infer.template import (  # noqa: F401
    build_high_res_template_from_era5,
    process_era5,
    process_topo,
)
