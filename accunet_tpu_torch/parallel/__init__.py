from accunet_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    ShardedParams,
    batch_slice,
    make_mesh,
    param_sharding_rules,
)
from accunet_tpu_torch.parallel.seq_scan import (
    active,
    sequence_parallel_scan,
    sequence_sharding,
    shard_mapped_scan,
    warn_divisibility_fallback,
)

__all__ = ["Mesh", "MeshSpec", "ShardedParams", "active", "batch_slice", "make_mesh",
           "param_sharding_rules", "sequence_parallel_scan", "sequence_sharding",
           "shard_mapped_scan", "warn_divisibility_fallback"]
