"""Tensor-parallel partition of the towers' parameters over the model axis,
and ZeRO-1 of the trainers' AdamW over the data axis.

Counterpart of ``vidil_tpu/parallel/sharding.py``. There the partition is
a PartitionSpec per leaf and GSPMD inserts the collectives; here each rank
keeps its slice of every sharded leaf (`shard_params`) and the towers'
linears run Megatron's column- and row-parallel pattern on it
(`models/layers.py`). The table of column-parallel kernels and biases and
of row-parallel kernels is JAX's (``_COLUMN_KERNELS``, ``_COLUMN_BIASES``,
``_ROW_KERNELS``), applied to the port's per-layer leaves as JAX applies
it to its stacked ones, `divisible_by` included (`model_partition_spec`).

One split differs from JAX's spec: the ViT's fused ``qkv`` kernel and
bias, whose column axis holds [q | k | v], are split by heads (this
rank's heads of q, of k and of v, side by side), not as contiguous
columns of the 3D axis. GSPMD can reshard a contiguous split before the
attention; attention on local heads needs the heads whole.

ZeRO-1 (``optimizer_sharding: zero1``, JAX's `apply_optimizer_sharding`):
`torch.distributed.optim.ZeroRedundancyOptimizer` wraps the same AdamW
over this rank's (local) parameters and the grid's data group: each data
rank keeps the moments of its partition, updates them from the summed
gradients and broadcasts them. A saved train state holds every moment:
`optimizer_state` consolidates them on the data group's first rank first,
a collective every rank calls.
"""

from __future__ import annotations

import torch

# path-suffix tables of the JAX package (vidil_tpu/parallel/sharding.py:22-42)
_COLUMN_KERNELS = (
    ("attn", "qkv", "kernel"),          # ViT fused qkv
    ("self_attn", "query", "kernel"),
    ("self_attn", "key", "kernel"),
    ("self_attn", "value", "kernel"),
    ("cross_attn", "query", "kernel"),
    ("cross_attn", "key", "kernel"),
    ("cross_attn", "value", "kernel"),
    ("attn", "query", "kernel"),        # CLIP towers
    ("attn", "key", "kernel"),
    ("attn", "value", "kernel"),
    ("mlp", "fc1", "kernel"),
)
_COLUMN_BIASES = tuple(path[:-1] + ("bias",) for path in _COLUMN_KERNELS)
_ROW_KERNELS = (
    ("attn", "proj", "kernel"),
    ("self_attn", "out", "kernel"),
    ("cross_attn", "out", "kernel"),
    ("attn", "out", "kernel"),
    ("mlp", "fc2", "kernel"),
)
_FUSED_QKV = (("attn", "qkv", "kernel"), ("attn", "qkv", "bias"))


def _endswith(names: tuple, suffix: tuple) -> bool:
    return len(names) >= len(suffix) and names[-len(suffix):] == suffix


def _jax_spec(names: tuple, shape: tuple, divisible_by: int) -> tuple:
    """JAX's `model_partition_spec` rule for one leaf of the JAX layout
    (`shape` with the stacked layer axis): its PartitionSpec entries."""
    if len(shape) == 3:
        if any(_endswith(names, s) for s in _COLUMN_KERNELS) and shape[2] % divisible_by == 0:
            return (None, None, "model")
        if any(_endswith(names, s) for s in _ROW_KERNELS) and shape[1] % divisible_by == 0:
            return (None, "model", None)
    if len(shape) == 2 and any(_endswith(names, s) for s in _COLUMN_BIASES):
        if shape[1] % divisible_by == 0:
            return (None, "model")
    return ()


def leaf_paths(tree, names=(), path="", stacked=False):
    """[(path, names, leaf, stacked)]: '/'-joined port path (list items by
    index, as `convert.named_leaves`), the path's dict keys, and whether
    the leaf is one layer of a per-layer list (a stacked leaf in JAX)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaf_paths(v, names + (k,), f"{path}{k}/", stacked)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, names, f"{path}{i}/", True)]
    return [(path[:-1], names, tree, stacked)]


def model_partition_spec(params, divisible_by: int = 1) -> dict:
    """{port path: spec} of a port tree: the spec of each leaf's own axes,
    ``(None, "model")`` for a column-parallel kernel, ``("model", None)``
    for a row-parallel one, ``("model",)`` for a column-parallel bias, and
    ``()`` for a replicated leaf. It is JAX's spec of the same leaf in the
    JAX layout with the stacked layer axis dropped: a per-layer leaf is
    ruled on as JAX's (L, ...) stack of it, `divisible_by` keeping a
    dimension the model axis does not divide replicated."""
    out = {}
    for path, names, leaf, stacked in leaf_paths(params):
        shape = tuple(leaf.shape)
        spec = _jax_spec(names, (1,) + shape if stacked else shape, divisible_by)
        out[path] = spec[1:] if stacked and spec else spec
    return out


def _axis(spec: tuple):
    return spec.index("model") if "model" in spec else None


def split_leaf(t: torch.Tensor, names: tuple, spec: tuple, model: int, model_rank: int):
    """This model rank's slice of the full leaf `t` under `spec`: a
    contiguous 1/model of the sharded axis, or for the fused qkv this
    rank's heads of q, of k and of v. A copy; a replicated leaf is `t`."""
    axis = _axis(spec)
    if axis is None:
        return t
    shape = tuple(t.shape)
    if any(_endswith(names, s) for s in _FUSED_QKV):
        v = t.reshape(shape[:axis] + (3, shape[axis] // 3) + shape[axis + 1:])
        n = shape[axis] // 3 // model
        part = v.narrow(axis + 1, model_rank * n, n)
        return part.reshape(shape[:axis] + (3 * n,) + shape[axis + 1:]).clone()
    n = shape[axis] // model
    return t.narrow(axis, model_rank * n, n).clone()


def join_leaf(t: torch.Tensor, names: tuple, spec: tuple, group) -> torch.Tensor:
    """The full leaf from every model rank's slice `t` (`split_leaf`'s
    inverse): an all-gather over the model group, a collective."""
    from vidil_tpu_torch.parallel.collectives import gather_along

    axis = _axis(spec)
    if axis is None:
        return t.detach()
    shape = tuple(t.shape)
    if any(_endswith(names, s) for s in _FUSED_QKV):
        v = t.detach().reshape(shape[:axis] + (3, shape[axis] // 3) + shape[axis + 1:])
        full = gather_along(v, axis + 1, group)
        return full.reshape(shape[:axis] + (-1,) + shape[axis + 1:])
    return gather_along(t, axis, group)


def rebuild_tree(tree, leaves):
    """`tree`'s structure with its leaves replaced, in `leaf_paths` order."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v) for v in node]
        return next(it)

    return rec(tree)


def shard_params(params, grid):
    """This rank's parameters under `grid`'s model axis (JAX's
    `shard_params`): `model_partition_spec` with ``divisible_by`` the
    model axis, each sharded leaf sliced (`split_leaf`), the replicated
    ones as they are. The towers run their linears as column- and
    row-parallel pairs, so every leaf of the table must be sharded: a
    width the model axis does not divide raises ValueError. The tree
    itself is returned when the model axis is 1."""
    if grid is None or grid.model == 1:
        return params
    specs = model_partition_spec(params, divisible_by=grid.model)
    ones = model_partition_spec(params)
    left = [p for p, s in ones.items() if s and not specs[p]]
    if left:
        raise ValueError(f"model_parallel {grid.model} does not divide the widths of "
                         f"{left[:3]}{' ...' if len(left) > 3 else ''}: a tensor-parallel "
                         f"tower needs its heads and hidden widths divisible")
    return rebuild_tree(params, [split_leaf(leaf, names, specs[path], grid.model,
                                            grid.model_rank)
                                 for path, names, leaf, _ in leaf_paths(params)])


def gather_params(params, grid):
    """The full parameters from every model rank's (`shard_params`' inverse,
    for saving and for the evaluation): an all-gather per sharded leaf over
    the model group, a collective every rank of it calls. The tree itself
    when the model axis is 1."""
    if grid is None or grid.model == 1:
        return params
    specs = model_partition_spec(params)
    return rebuild_tree(params, [join_leaf(leaf, names, specs[path], grid.model_group)
                                 for path, names, leaf, _ in leaf_paths(params)])


def replicated_leaves(params) -> list:
    """The leaves of a (sharded) tree that the model axis replicates."""
    specs = model_partition_spec(params)
    return [leaf for path, _, leaf, _ in leaf_paths(params) if not specs[path]]


def apply_optimizer_sharding(state, config: dict):
    """Wrap ``state.optimizer`` in ZeRO-1 over the state's data group (the
    world without a grid) under ``optimizer_sharding: zero1`` when a
    process group runs (any world, one rank included); without one, or
    with the key absent, the state is returned as it is."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from vidil_tpu_torch.utils.dist import get_world_size, is_dist_avail_and_initialized

    mode = config.get("optimizer_sharding")
    if mode in (None, "", "none", False):
        return state
    if mode != "zero1":
        raise ValueError(f"unknown optimizer_sharding: {mode!r}")
    if not is_dist_avail_and_initialized() or is_zero1(state.optimizer):
        return state
    grid = getattr(state, "grid", None)
    group = grid.data_group if grid is not None else None
    opt = state.optimizer
    pg = opt.param_groups[0]
    params = list(pg["params"])
    state.optimizer = ZeroRedundancyOptimizer(
        params, optimizer_class=torch.optim.AdamW, process_group=group, lr=pg["lr"],
        betas=pg["betas"], eps=pg["eps"], weight_decay=pg["weight_decay"])
    dp = grid.data if grid is not None else get_world_size()
    print(f"optimizer state sharded over the data axis (ZeRO-1, dp={dp})")
    return state


def is_zero1(optimizer) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(optimizer, ZeroRedundancyOptimizer)


def optimizer_state(optimizer) -> dict:
    """{parameter: its AdamW state} of every parameter. Plain AdamW: its
    state. ZeRO-1: a collective: every rank calls it, the first rank of
    the optimizer's data group gets every partition's state
    (`consolidate_state_dict`), the others an empty dict."""
    if not is_zero1(optimizer):
        return optimizer.state
    import torch.distributed as dist

    optimizer.consolidate_state_dict(to=0)
    if dist.get_rank(optimizer.process_group) != 0:
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
