from .dist import (
    all_reduce_max,
    all_reduce_sum,
    all_reduce_sum_differentiable,
    barrier,
    broadcast_from_0,
    broadcast_module_,
    free_port,
    init_distributed,
    launch_ranks,
    launched,
    process_info,
    rank_device,
)
