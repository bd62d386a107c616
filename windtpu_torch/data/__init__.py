from windtpu_torch.data.noise import FlexibleNoiseGenerator, NoiseGenerator  # noqa: F401
from windtpu_torch.data.decoders import (  # noqa: F401
    NaiveDecoder,
    WindComponentDecoder,
    WindSpeedDecoder,
)
from windtpu_torch.data.providers import (GCSFileProvider,  # noqa: F401
                                          LocalFileProvider, Provider,
                                          S3FileProvider)
from windtpu_torch.data.batch import BatchGenerator, SyntheticDayProvider  # noqa: F401
