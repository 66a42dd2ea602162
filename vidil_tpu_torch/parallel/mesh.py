"""The data axis of the port: the world of ranks.

Counterpart of ``vidil_tpu/parallel/mesh.py:mesh_from_config``. JAX runs
one program over a ('data', 'model') mesh of a host's chips; the torch
idiom is one process per GPU, so the port's data axis is the process
group: ``data_parallel: N`` asks for a world of N ranks, and rank r takes
rows [r*B/N, (r+1)*B/N) of each global batch of B rows. Tensor
parallelism (``model_parallel > 1``) is not ported and raises.
"""

from __future__ import annotations

from vidil_tpu_torch.utils.dist import get_rank, get_world_size


def data_parallel_from_config(config: dict) -> int:
    """The size of the data axis a config asks for: the world size.

    ``data_parallel`` absent, 0 or True (the inference CLIs' switch) takes
    the launch's world as it is, one rank included; an integer N must
    equal the world size. ``model_parallel > 1`` raises NotImplementedError."""
    if int(config.get("model_parallel", 1) or 1) > 1:
        raise NotImplementedError(
            "vidil_tpu_torch: model_parallel > 1 (tensor parallelism) is not ported yet")
    world = get_world_size()
    dp = config.get("data_parallel", 0)
    if dp is True or not dp:
        return world
    if int(dp) != world:
        raise ValueError(f"data_parallel: {dp} needs a world of {dp} ranks "
                         f"(WORLD_SIZE={dp}); this launch has {world}")
    return world


def local_rows(n_global: int, rank: int | None = None, world: int | None = None) -> slice:
    """This rank's rows of a global batch of `n_global` rows, which the
    world must divide."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world is None else world
    assert n_global % world == 0, f"global batch {n_global} must divide the data axis {world}"
    n = n_global // world
    return slice(rank * n, (rank + 1) * n)
