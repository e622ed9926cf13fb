from centerpose_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    launch,
    replicate,
    shard_batch,
)
