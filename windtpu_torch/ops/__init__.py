from windtpu_torch.ops.convlstm import (  # noqa: F401
    convlstm_seq,
    convlstm_seq_plain,
)
from windtpu_torch.ops.ks import spatial_ks  # noqa: F401
