"""ZeRO-1 of the trainers' AdamW: the moments sharded over the data axis.

Counterpart of ``vidil_tpu/parallel/sharding.py:apply_optimizer_sharding``
(``optimizer_sharding: zero1``). There each moment leaf is sharded over the
'data' mesh axis and XLA schedules reduce-scatter, sharded update and
all-gather. Here `torch.distributed.optim.ZeroRedundancyOptimizer` wraps
the same AdamW: each rank keeps the moments of its partition of the
parameters, updates them from the summed gradients, and broadcasts them.
A saved train state holds every moment: `optimizer_state` consolidates
them on rank 0 first, a collective every rank calls. The tensor-parallel
partition specs (`model_partition_spec`) wait for tensor parallelism.
"""

from __future__ import annotations


def apply_optimizer_sharding(state, config: dict):
    """Wrap ``state.optimizer`` in ZeRO-1 under ``optimizer_sharding:
    zero1`` when a process group runs (any world, one rank included);
    without one, or with the key absent, the state is returned as it is."""
    import torch
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from vidil_tpu_torch.utils.dist import get_world_size, is_dist_avail_and_initialized

    mode = config.get("optimizer_sharding")
    if mode in (None, "", "none", False):
        return state
    if mode != "zero1":
        raise ValueError(f"unknown optimizer_sharding: {mode!r}")
    if not is_dist_avail_and_initialized() or is_zero1(state.optimizer):
        return state
    opt = state.optimizer
    group = opt.param_groups[0]
    params = list(group["params"])
    state.optimizer = ZeroRedundancyOptimizer(
        params, optimizer_class=torch.optim.AdamW, lr=group["lr"], betas=group["betas"],
        eps=group["eps"], weight_decay=group["weight_decay"])
    print(f"optimizer state sharded over the data axis (ZeRO-1, dp={get_world_size()})")
    return state


def is_zero1(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def optimizer_state(optimizer) -> dict:
    """{parameter: its AdamW state} of every parameter. Plain AdamW: its
    state. ZeRO-1: a collective: every rank calls it, rank 0 gets every
    partition's state (`consolidate_state_dict`), the others an empty
    dict."""
    if not is_zero1(optimizer):
        return optimizer.state
    from vidil_tpu_torch.utils.dist import is_main_process

    optimizer.consolidate_state_dict(to=0)
    if not is_main_process():
        return {}
    full = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {params[i]: st for i, st in full["state"].items()}


def set_param_state(optimizer, p, st: dict) -> None:
    """Give parameter `p` the AdamW state `st`; under ZeRO-1 only the rank
    that owns `p` keeps it."""
    if not is_zero1(optimizer):
        optimizer.state[p] = st
        return
    local = optimizer.optim
    if any(q is p for g in local.param_groups for q in g["params"]):
        local.state[p] = st
