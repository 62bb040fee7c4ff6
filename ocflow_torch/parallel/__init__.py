"""Data parallelism over several processes (port of ``ocflow_tpu.parallel``):
the process group, the data mesh and its collectives, global-batch
statistics (``synced_stats``), the rank-wide metrics, and the
height-sharded cost volume and warp."""

from ocflow_torch.parallel.distributed import (BACKENDS, global_mean_metrics, initialize,
                                               is_main_process, local_device,
                                               local_shard_info, process_group,
                                               world_size)
from ocflow_torch.parallel.mesh import (Mesh, batch_sharding, check_replicated,
                                        default_mesh, make_mesh, replicated, shard_batch,
                                        synced_stats)
from ocflow_torch.parallel.spatial import halo_exchange, spatial_cost_volume, spatial_warp

__all__ = [
    "BACKENDS",
    "Mesh",
    "make_mesh",
    "default_mesh",
    "batch_sharding",
    "replicated",
    "check_replicated",
    "shard_batch",
    "synced_stats",
    "initialize",
    "is_main_process",
    "global_mean_metrics",
    "local_shard_info",
    "local_device",
    "process_group",
    "world_size",
    "halo_exchange",
    "spatial_cost_volume",
    "spatial_warp",
]
