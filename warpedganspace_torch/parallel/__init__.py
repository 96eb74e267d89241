"""Several cards, one process each: data-parallel training and split work
lists over ``torch.distributed`` (counterpart of
:mod:`warpedganspace_tpu.parallel`)."""

from warpedganspace_torch.parallel.mesh import (
    active,
    all_reduce_sum,
    assert_identical_across_processes,
    gather_to_coordinator,
    host_threads,
    initialize_distributed,
    is_coordinator,
    launch_error,
    local_device,
    partition_work,
    rank,
    rank_block,
    sync_processes,
    world_size,
)

__all__ = ["active", "all_reduce_sum", "assert_identical_across_processes",
           "gather_to_coordinator", "host_threads", "initialize_distributed",
           "is_coordinator", "launch_error", "local_device", "partition_work", "rank",
           "rank_block", "sync_processes", "world_size"]
