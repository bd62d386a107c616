from windtpu_torch.io.dataset import DataArray, Dataset, open_dataset, open_mfdataset  # noqa: F401
from windtpu_torch.io.geotiff import open_rasterio  # noqa: F401
