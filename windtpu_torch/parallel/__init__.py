from windtpu_torch.core.mesh import make_mesh, shard_batch  # noqa: F401
from windtpu_torch.parallel.distributed import (  # noqa: F401
    agree,
    initialize_distributed,
    replicate_to_mesh,
)
from windtpu_torch.parallel.shard_step import make_sharded_train_step  # noqa: F401
