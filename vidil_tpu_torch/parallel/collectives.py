"""Collectives over the ranks of a process group: the port's counterpart
of ``vidil_tpu/parallel/collectives.py`` (reference:
models/blip_retrieval.py:576-622), and the two operators of Megatron's
tensor-parallel linears.

* `concat_all_gather`: every rank's tensor concatenated along dim 0, with
  no gradient.
* `all_gather_with_grad`: the same concatenation, differentiable: the
  backward sums the cotangent over the ranks (all-reduce) and keeps this
  rank's slice, the reference's GatherLayer and JAX's all_gather VJP.
* `psum`, `pmean`: the sum and mean over the ranks, out of place.
* `copy_to_model` (identity forward, all-reduce backward) and
  `reduce_from_model` (all-reduce forward, identity backward): a
  column-parallel linear's input and a row-parallel linear's output over
  the model group (`models/layers.py`).
* `gather_from_model` (all-gather forward, this rank's slice of the
  cotangent backward): a sharded leaf made whole for a computation every
  model rank repeats on the same inputs (the fused ViT block,
  `models/vit.py`).

Every collective takes a `group` (None: the whole world, torch's default);
the trainers pass their grid's data group (`parallel/mesh.py:Grid`) to the
data-parallel ones, so that a grid with a model axis gathers and sums over
the data ranks only, not over the model ranks' duplicates. Every rank of
the group passes a tensor of the same shape. Without a process group each
is the identity (a world of one). Under NCCL the collectives run on the
device; gloo has no all-gather for CUDA tensors, so under gloo a CUDA
tensor is staged through the host explicitly (and under NCCL a host
tensor through the GPU), and the result returns to its device.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.utils.dist import is_dist_avail_and_initialized


def _size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def _staged(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` on the device its collective runs on: itself, except a CUDA
    tensor under gloo, which goes to the host, and a host tensor under
    NCCL (a consolidated optimizer moment), which goes to this rank's GPU."""
    import torch.distributed as dist

    nccl = dist.get_backend(group) == "nccl"
    if x.is_cuda and not nccl:
        return x.detach().cpu()
    if nccl and not x.is_cuda:
        return x.detach().to(torch.device("cuda", torch.cuda.current_device()))
    return x.detach().contiguous()


def _gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    import torch.distributed as dist

    src = _staged(x, group)
    parts = [torch.empty_like(src) for _ in range(_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    import torch.distributed as dist

    buf = _staged(x, group).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


@torch.no_grad()
def concat_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """No-grad all-gather along dim 0 (reference :576-587)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return _gather(x, group)


@torch.no_grad()
def gather_along(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """No-grad all-gather of the group's tensors, concatenated along `dim`
    in group-rank order (the inverse of a contiguous split)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return _gather(x, group, dim)


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.n, ctx.group = x.shape[0], group
        ctx.rank = dist.get_rank(group)
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce_sum(grad, ctx.group)
        start = ctx.rank * ctx.n
        return grad[start:start + ctx.n], None


def all_gather_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Grad-preserving all-gather along dim 0 (reference GatherLayer
    :590-622): backward = all-reduce of the cotangent, then this rank's
    slice."""
    if not is_dist_avail_and_initialized():
        return x
    return _AllGatherWithGrad.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks, out of place (no gradient)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return _all_reduce_sum(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks, out of place (no gradient)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return psum(x, group) / _size(group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist

        ctx.dim, ctx.n, ctx.rank = dim, x.shape[dim], dist.get_rank(group)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's tensors concatenated along `dim` in rank order,
    differentiable, for a computation that every rank of the group repeats
    on the same inputs: each rank then holds the same whole cotangent, so
    the backward keeps this rank's slice of it. Neither an all-reduce nor a
    reduce-scatter, which would multiply the gradient by the group's
    size (`all_gather_with_grad` is for ranks with different inputs)."""
    return _GatherFromModel.apply(x, dim, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of column-parallel linears, replicated over the model
    group: identity forward; the backward sums the ranks' partial input
    gradients (each rank's columns contribute theirs)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel linear: the ranks' partial sums added
    (all-reduce) forward; the backward hands the replicated cotangent to
    each rank's partial product unchanged."""
    return _ReduceFromModel.apply(x, group)


def _bucketed(tensors, bucket_elems: int, fn) -> None:
    """Apply `fn` (flat tensor -> flat tensor, a collective) to `tensors` in
    flat buckets of at most `bucket_elems` elements per dtype and device,
    writing the results back in place."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        bucket, size = [], 0
        for t in group + [None]:
            if t is not None and (not bucket or size + t.numel() <= bucket_elems):
                bucket.append(t)
                size += t.numel()
                continue
            flat = fn(torch.cat([b.reshape(-1) for b in bucket]))
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            bucket, size = ([t], t.numel()) if t is not None else ([], 0)


@torch.no_grad()
def all_reduce_grads(params, group=None, bucket_elems: int = 1 << 24) -> None:
    """Sum every ``.grad`` of `params` (tensors) over the group's ranks, in
    place, in flat buckets of at most `bucket_elems` elements per dtype.
    Leaves without a gradient are skipped: they are the same on every rank,
    whose graphs are the same. A no-op without a process group."""
    if not is_dist_avail_and_initialized():
        return
    _bucketed([p.grad for p in params if p.grad is not None], bucket_elems,
              lambda flat: _all_reduce_sum(flat, group))


def _broadcast_first(flat: torch.Tensor, group) -> torch.Tensor:
    """`flat` of the group's first rank, on every rank of the group."""
    import torch.distributed as dist

    buf = _staged(flat, group).clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(flat.device)


@torch.no_grad()
def broadcast_first(tensors: dict, group) -> dict:
    """{name: the group's first rank's tensor} on every rank of the group:
    the model ranks of one data rank must compute on one input, and a
    loader's random augmentations, drawn in its threads, need not agree
    across processes."""
    return {k: _broadcast_first(t, group) for k, t in tensors.items()}


@torch.no_grad()
def broadcast_grads(params, group, bucket_elems: int = 1 << 24) -> None:
    """Give every rank of `group` its first rank's ``.grad`` of `params`,
    in place: the leaves the model axis replicates get one gradient, as
    the JAX program computes it once, even where a kernel's atomic adds
    round in another order on another rank."""
    if not is_dist_avail_and_initialized():
        return
    _bucketed([p.grad for p in params if p.grad is not None], bucket_elems,
              lambda flat: _broadcast_first(flat, group))
