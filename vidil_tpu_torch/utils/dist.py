"""Process utilities on top of ``torch.distributed``: rendezvous, rank, world
size, print gating, barrier, rank-0 saves.

The port's own copy of ``vidil_tpu/utils/dist.py`` in the torch idiom: one
process per GPU (torchrun's launch), where the JAX package runs one process
per host. The rendezvous reads torchrun's variables (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK) or SLURM's (SLURM_PROCID,
SLURM_NTASKS, SLURM_LOCALID). The backend is NCCL on CUDA and gloo on the
CPU; the caller may name both. The per-rank tmp-JSON -> rank-0 merge
contract of the CLIs (`utils/io.py`) keeps their files the same for any
number of ranks.
"""

from __future__ import annotations

import builtins
import datetime
import os

_BUILTIN_PRINT = builtins.print


def is_dist_avail_and_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    if is_dist_avail_and_initialized():
        import torch.distributed as dist

        return dist.get_world_size()
    return 1


def get_rank() -> int:
    if is_dist_avail_and_initialized():
        import torch.distributed as dist

        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Print only on the master process; ``print(..., force=True)`` prints
    on every rank (reference: utils.py:214-226)."""

    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            _BUILTIN_PRINT(*args, **kwargs)

    builtins.print = print_fn


def _env_rendezvous():
    """(rank, world, local_rank) from torchrun's or SLURM's variables; None
    when neither describes a launch (a plain single process)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        return rank, world, int(env.get("LOCAL_RANK", rank))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        return rank, world, int(env.get("SLURM_LOCALID", rank))
    if int(env.get("WORLD_SIZE", env.get("SLURM_NTASKS", "1"))) > 1:
        raise RuntimeError("vidil_tpu_torch: WORLD_SIZE > 1 without RANK (or SLURM_NTASKS "
                           "without SLURM_PROCID): launch with torchrun, or set both")
    return None


def init_distributed_mode(args=None, backend: str | None = None, device=None) -> bool:
    """Join the process group the environment describes.

    Without a launch's variables the process stays single-process. A
    launch (torchrun's, any world, one rank included) joins a process
    group: the backend is `backend`, else NCCL when `device` (default: CUDA
    where available) is a CUDA device and gloo on the CPU. Under NCCL each rank
    takes ``cuda:LOCAL_RANK``; more ranks on a host than visible GPUs
    raise, as NCCL cannot put two ranks on one GPU. A process group the
    caller already initialised is left as it is. Sets ``args.rank``,
    ``args.world_size``, ``args.distributed`` and ``args.gpu`` when given
    `args`. Returns True when this call created the group (the caller then
    ends it with `destroy_distributed`)."""
    import torch
    import torch.distributed as dist

    if is_dist_avail_and_initialized():
        _fill_args(args, get_rank(), get_world_size(), None)
        return False
    launch = _env_rendezvous()
    if launch is None:
        _fill_args(args, 0, 1, None)
        return False
    rank, world, local = launch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    gpu = None
    if backend == "nccl":
        n_gpus = torch.cuda.device_count()
        if local >= n_gpus:
            raise RuntimeError(
                f"vidil_tpu_torch: NCCL needs one GPU per rank; local rank {local} of a world "
                f"of {world} sees {n_gpus} GPU(s). Launch at most {n_gpus} ranks per host, or "
                "pass backend='gloo' explicitly")
        gpu = local
        torch.cuda.set_device(gpu)
    elif device.type == "cuda":
        gpu = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.set_device(gpu)
    master = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    kw = {"device_id": torch.device("cuda", gpu)} if backend == "nccl" else {}
    dist.init_process_group(backend=backend, init_method=f"tcp://{master}:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(hours=2), **kw)
    _fill_args(args, rank, world, gpu)
    setup_for_distributed(rank == 0)
    return True


def _fill_args(args, rank: int, world: int, gpu) -> None:
    if args is not None:
        args.rank = rank
        args.world_size = world
        args.distributed = world > 1
        args.gpu = gpu


def collective_device():
    """The device a collective's tensors live on: the current GPU under
    NCCL, the CPU otherwise."""
    import torch
    import torch.distributed as dist

    if is_dist_avail_and_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Cross-process barrier; a no-op in single-process mode. Under NCCL
    it names this rank's GPU (`device_ids`)."""
    if not is_dist_avail_and_initialized():
        return
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def grid_groups(data: int, model: int):
    """The process groups of a (data, model) grid of the world's ranks, in
    the JAX package's mesh order (``make_mesh``: rank = d * model + m):
    (data_group, data_rank, model_group, model_rank). This rank's data
    group holds the ranks of its model index m, one per data index; its
    model group the ranks of its data index d. `dist.new_group` is a
    collective, so every rank calls this with the same sizes; the groups
    of one grid are made once per process group and reused. A model axis
    of 1 has no model group (None), and a data axis that is the whole world
    is the world's own group."""
    import torch.distributed as dist

    key = (data, model)
    if key not in _GRIDS:
        rank = get_rank()
        if model == 1:
            _GRIDS[key] = (dist.group.WORLD, rank, None, 0)
        else:
            data_group, _ = dist.new_subgroups_by_enumeration(
                [[d * model + m for d in range(data)] for m in range(model)])
            model_group, _ = dist.new_subgroups_by_enumeration(
                [[d * model + m for m in range(model)] for d in range(data)])
            _GRIDS[key] = (data_group, rank // model, model_group, rank % model)
    return _GRIDS[key]


_GRIDS: dict = {}


def destroy_distributed() -> None:
    """Leave the process group (the CLIs' exit); a no-op without one.
    Restores the builtin print."""
    if is_dist_avail_and_initialized():
        import torch.distributed as dist

        barrier()
        dist.destroy_process_group()
    _GRIDS.clear()
    builtins.print = _BUILTIN_PRINT


def save_on_master(save_fn, *args, **kwargs) -> None:
    """Run ``save_fn`` on rank 0 only (reference: utils.py:253-255)."""
    if is_main_process():
        save_fn(*args, **kwargs)
