"""The port's multi-process runtime: collectives over the ranks, the data
axis (the world of ranks) and ZeRO-1 of the optimizer. The process group
itself is set up by `vidil_tpu_torch.utils.dist.init_distributed_mode`."""

from vidil_tpu_torch.parallel.collectives import (
    all_gather_with_grad,
    all_reduce_grads,
    concat_all_gather,
    pmean,
    psum,
)
from vidil_tpu_torch.parallel.mesh import (
    data_parallel_from_config,
    local_rows,
)
from vidil_tpu_torch.parallel.sharding import apply_optimizer_sharding
