"""Several cards, one process each: data-parallel training and split work
lists over ``torch.distributed`` (counterpart of
:mod:`warpedganspace_tpu.parallel`)."""

from warpedganspace_torch.parallel.mesh import (
    active,
    all_reduce_sum,
    assert_identical_across_processes,
    initialize_distributed,
    is_coordinator,
    launch_error,
    local_device,
    partition_work,
    rank,
    sync_processes,
    world_size,
)

__all__ = ["active", "all_reduce_sum", "assert_identical_across_processes",
           "initialize_distributed", "is_coordinator", "launch_error", "local_device",
           "partition_work", "rank", "sync_processes", "world_size"]
