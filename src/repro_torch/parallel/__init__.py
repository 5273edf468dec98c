"""Sharding of the port: the device mesh and its placements
(``sharding``), the BSS index partitioned over it by blocks
(``shard_index``) and the train step over it (``sharded_step``), one
controlling process for every device."""

from repro_torch.parallel.sharding import (
    P,
    Placement,
    ShardedTensor,
    ShardMesh,
    check_mesh,
    dp_axes,
    local_mesh,
    n_shards,
    shard_devices,
)

__all__ = ["P", "Placement", "ShardedTensor", "ShardMesh", "check_mesh", "dp_axes",
           "local_mesh", "n_shards", "shard_devices"]
