"""Collectives over the ranks of the process group: the port's counterpart
of ``vidil_tpu/parallel/collectives.py`` (reference:
models/blip_retrieval.py:576-622).

* `concat_all_gather`: every rank's tensor concatenated along dim 0, with
  no gradient.
* `all_gather_with_grad`: the same concatenation, differentiable: the
  backward sums the cotangent over the ranks (all-reduce) and keeps this
  rank's slice, the reference's GatherLayer and JAX's all_gather VJP.
* `psum`, `pmean`: the sum and mean over the ranks, out of place.

Every rank passes a tensor of the same shape. Without a process group each
is the identity (a world of one). Under NCCL the collectives run on the
device; gloo has no all-gather for CUDA tensors, so under gloo a CUDA
tensor is staged through the host explicitly and the result returns to
its device.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.utils.dist import get_rank, get_world_size, is_dist_avail_and_initialized


def _staged(x: torch.Tensor) -> torch.Tensor:
    """`x` on the device its collective runs on: itself, except a CUDA
    tensor under gloo, which goes to the host."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend() != "nccl":
        return x.detach().cpu()
    return x.detach().contiguous()


def _gather(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    src = _staged(x)
    parts = [torch.empty_like(src) for _ in range(get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=0).to(x.device)


def _all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    buf = _staged(x).clone()
    dist.all_reduce(buf)
    return buf.to(x.device)


@torch.no_grad()
def concat_all_gather(x: torch.Tensor) -> torch.Tensor:
    """No-grad all-gather along dim 0 (reference :576-587)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return _gather(x)


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce_sum(grad)
        start = get_rank() * ctx.n
        return grad[start:start + ctx.n]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Grad-preserving all-gather along dim 0 (reference GatherLayer
    :590-622): backward = all-reduce of the cotangent, then this rank's
    slice."""
    if not is_dist_avail_and_initialized():
        return x
    return _AllGatherWithGrad.apply(x)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, out of place (no gradient)."""
    if not is_dist_avail_and_initialized():
        return x.detach()
    return _all_reduce_sum(x)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks, out of place (no gradient)."""
    return psum(x) / get_world_size()


@torch.no_grad()
def all_reduce_grads(params, bucket_elems: int = 1 << 24) -> None:
    """Sum every ``.grad`` of `params` (tensors) over the ranks, in place,
    in flat buckets of at most `bucket_elems` elements per dtype. Leaves
    without a gradient are skipped: they are the same on every rank, whose
    graphs are the same. A no-op without a process group."""
    if not is_dist_avail_and_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault((g.dtype, g.device), []).append(g)
    for group in by_dtype.values():
        bucket, size = [], 0
        for g in group + [None]:
            if g is not None and (not bucket or size + g.numel() <= bucket_elems):
                bucket.append(g)
                size += g.numel()
                continue
            flat = _all_reduce_sum(torch.cat([t.reshape(-1) for t in bucket]))
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
            bucket, size = ([g], g.numel()) if g is not None else ([], 0)
