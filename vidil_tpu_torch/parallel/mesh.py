"""The port's (data, model) grid of ranks.

Counterpart of ``vidil_tpu/parallel/mesh.py`` (`make_mesh`,
`mesh_from_config`). JAX runs one program over a ('data', 'model') mesh
of a host's chips; the torch idiom is one process per GPU, so the port's
mesh is a grid of the world's ranks in the mesh's order: rank
r = d * model + m sits at data index d and model index m. The data axis
splits each global batch (data rank d takes rows [d*B/D, (d+1)*B/D)); the
model axis splits the attention heads and the MLP's hidden columns of the
towers (`parallel/sharding.py`, Megatron's column- and row-parallel
linears on `parallel/collectives.py`'s two operators).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vidil_tpu_torch.utils.dist import (
    get_rank,
    get_world_size,
    grid_groups,
    is_dist_avail_and_initialized,
)


@dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid and its two groups.

    ``data_group`` is None without a process group (one process: no
    collective runs); under one, the step's data-parallel collectives
    (gradient all-reduce, loss sums, ITA gathers) run over it, one rank
    included. ``model_group`` is None unless ``model > 1``."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def data_parallel(self) -> bool:
        return self.data_group is not None

    @property
    def tensor_parallel(self) -> bool:
        return self.model > 1

    @property
    def gate(self) -> tuple:
        """(data, model): the factors by which the step's global attention
        shape exceeds one rank's, batch and heads (`attention_auto`)."""
        return (self.data, self.model)


def make_grid(data: int, model: int = 1) -> Grid:
    """The grid of `data` x `model` ranks, which must be the world: its
    groups (`utils.dist.grid_groups`, a collective under a process group).
    Without a process group only the 1 x 1 grid exists."""
    world = get_world_size()
    if data * model != world:
        raise ValueError(f"data_parallel {data} x model_parallel {model} = {data * model} "
                         f"ranks, but this launch has a world of {world}")
    if not is_dist_avail_and_initialized():
        return Grid()
    data_group, data_rank, model_group, model_rank = grid_groups(data, model)
    return Grid(data, model, data_rank, model_rank, data_group, model_group)


def world_grid() -> Grid:
    """The data axis alone over the whole world (the steps' default): the
    trivial grid without a process group."""
    return make_grid(get_world_size(), 1)


def grid_from_config(config: dict) -> Grid:
    """The grid a config asks for, as ``mesh_from_config`` reads it:
    ``model_parallel`` (default 1) is the model axis; ``data_parallel``
    absent, 0 or True (the inference CLIs' switch) takes the rest of the
    world for the data axis, and an integer N is the data axis. The product
    must equal the launch's world: a mismatch (or a world the model axis
    does not divide) raises ValueError naming both sizes."""
    world = get_world_size()
    tp = int(config.get("model_parallel", 1) or 1)
    dp = config.get("data_parallel", 0)
    if dp is True or not dp:
        if world % tp:
            raise ValueError(f"model_parallel {tp} does not divide the world of {world} ranks "
                             f"(data_parallel {world / tp:g})")
        dp = world // tp
    return make_grid(int(dp), tp)


def rank_grid(data: int, model: int) -> np.ndarray:
    """The (data, model) array of global ranks, `make_mesh`'s device order."""
    return np.arange(data * model).reshape(data, model)


def local_rows(n_global: int, rank: int | None = None, world: int | None = None) -> slice:
    """Data rank `rank`'s rows of a global batch of `n_global` rows over a
    data axis of `world`, which must divide it (default: this rank, the
    whole world)."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    assert n_global % world == 0, f"global batch {n_global} must divide the data axis {world}"
    n = n_global // world
    return slice(rank * n, (rank + 1) * n)
