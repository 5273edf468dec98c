"""Sharding of the port: the device mesh (``sharding``) and the BSS index
partitioned over it by blocks (``shard_index``), one controlling process
for every device."""

from repro_torch.parallel.sharding import (
    ShardMesh,
    check_mesh,
    dp_axes,
    local_mesh,
    n_shards,
    shard_devices,
)

__all__ = ["ShardMesh", "check_mesh", "dp_axes", "local_mesh", "n_shards", "shard_devices"]
