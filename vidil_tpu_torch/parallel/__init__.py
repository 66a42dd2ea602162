"""The port's multi-process runtime: the (data, model) grid of ranks,
collectives over its groups, the tensor-parallel partition of the
parameters and ZeRO-1 of the optimizer. The process group itself is set up
by `vidil_tpu_torch.utils.dist.init_distributed_mode`."""

from vidil_tpu_torch.parallel.collectives import (
    all_gather_with_grad,
    all_reduce_grads,
    concat_all_gather,
    copy_to_model,
    pmean,
    psum,
    reduce_from_model,
)
from vidil_tpu_torch.parallel.mesh import (
    Grid,
    grid_from_config,
    local_rows,
    make_grid,
)
from vidil_tpu_torch.parallel.sharding import (
    apply_optimizer_sharding,
    gather_params,
    model_partition_spec,
    shard_params,
)
