"""Several devices: song-sharded serving and the data-parallel group
(port of ``pfann_tpu/parallel``)."""

from pfann_tpu_torch.parallel.mesh import (
    init_data_parallel,
    local_devices,
    spawn_ranks,
)
from pfann_tpu_torch.parallel.sharded_search import ShardedDatabase

__all__ = ["ShardedDatabase", "init_data_parallel", "local_devices", "spawn_ranks"]
