from windtpu_torch.ops.convlstm import (  # noqa: F401
    convlstm_seq,
    convlstm_seq_plain,
)
