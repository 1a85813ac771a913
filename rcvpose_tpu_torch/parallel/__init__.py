"""Data parallelism of the port (counterpart of ``rcvpose_tpu.parallel``).

``batch_sharding`` and ``replicated`` have no counterpart: a port mesh
places whole tensors on devices and splits batches itself.
"""
from rcvpose_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce,
    data_mesh,
    host_allgather,
    host_allgather_concat,
    local_data_mesh,
    local_devices,
    process_count,
    process_index,
    shard_batch,
    sharded_frame_pose,
    sharded_frame_scores,
    sharded_vote_counts,
    warm_collectives,
)
from rcvpose_tpu_torch.parallel.launch import (  # noqa: F401
    free_port,
    run_ranks,
)
