"""Flash attention, forward and backward: the hand-written Hopper kernels,
their plain twins, the autograd Function that pairs them, and the
attention dispatch.

`flash_attention(q, k, v)` computes softmax(q·kᵀ/√D)·v for q (B, H, Lq, D)
and k, v (B, H, Lk, D), with no mask, and is differentiable through
`FlashAttentionFunction`. On CUDA tensors the forward launches the kernel
in ``csrc/flash_attention_fwd.cu`` (the counterpart of the TPU kernel
``vidil_tpu/ops/flash_attention.py:_flash_forward``; with its logsumexp rows
when a gradient will be taken) and the backward launches
``csrc/flash_attention_bwd.cu`` (the counterpart of ``_flash_backward``;
a dq kernel, then a dk/dv kernel).
On CPU tensors the same Function runs the plain twins,
`flash_attention_ref` and `flash_attention_bwd_ref`, which keep the
kernels' rounding points. Nothing falls back: a CUDA launch that cannot run
raises.

Forward rounding points (the TPU kernel's): q is pre-scaled by 1/√D in the
input dtype; q·kᵀ accumulates in fp32; the running max and sum are fp32; p
is rounded to v's dtype before both P·V and the row sum; keys past Lk score
-1e30; o = acc / l in the input dtype; lse = m + log(l) in fp32.
Backward rounding points: see `flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from vidil_tpu_torch.models.layers import dot_product_attention

NEG_INF = -1e30

# query rows per block and keys per K/V tile of the CUDA forward kernel, per
# dtype (kBlockM/kBlockN for the bf16 wgmma kernel, kF32BlockM/kF32BlockN for
# the fp32 one, in the source): the online softmax's running max advances
# once per key tile, so the twin reproduces the kernel's bf16 rounding when
# it walks the same tiles (block_k=KERNEL_BLOCK_K[dtype])
KERNEL_BLOCK_M = {torch.bfloat16: 128, torch.float32: 64}
KERNEL_BLOCK_K = {torch.bfloat16: 128, torch.float32: 64}
KERNEL_HEAD_DIM = 64

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# launches of the CUDA kernels by this process, for showing that a run went
# through them; `reset_launch_counts` sets them back to 0.
# flash_attention_fwd counts the inference forward, flash_attention_fwd_lse
# the training forward (with logsumexp rows), flash_attention_bwd the backward
launch_counts = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0,
                 "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kernel_tiles(Lq: int, Lk: int, dtype) -> tuple[int, int, int]:
    """The forward kernel's tiling of one (batch, head): (query tiles, key
    tiles, real keys in the last key tile). A call has B*H*query-tiles work
    items; each walks every key tile, and the last one's keys past Lk score
    -1e30."""
    bm, bk = KERNEL_BLOCK_M[dtype], KERNEL_BLOCK_K[dtype]
    k_tiles = -(-Lk // bk)
    return -(-Lq // bm), k_tiles, Lk - (k_tiles - 1) * bk


def _acc_dtype(dtype):
    """fp32 accumulation for bf16/fp32 inputs (the kernels'); fp64 inputs
    stay fp64, so that gradcheck can run the twins."""
    return torch.promote_types(dtype, torch.float32)


def _mm(a, b, acc):
    """a @ b with the product accumulated in `acc` (a bf16 x bf16 product
    is exact in fp32, so upcasting the operands computes the sums of a
    tensor-core product with fp32 accumulation)."""
    return torch.matmul(a.to(acc), b.to(acc))


def _scale(D: int, dtype, device):
    """1/√D rounded to the input dtype, as the kernels pre-scale q."""
    return torch.tensor(1.0 / math.sqrt(D), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _scale_value(D: int, dtype) -> float:
    """`_scale` as the Python float the kernels take (computed once)."""
    return _scale(D, dtype, "cpu").item()


def flash_attention_ref(q, k, v, block_k: int | None = None, return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, tile by tile.

    block_k: keys per online-softmax step. None takes the TPU kernel's
    rule (one block of round_up(Lk, 128) keys up to 2048, else 512), so
    that on the CPU the twin follows the JAX kernel's schedule;
    KERNEL_BLOCK_K[dtype] follows the CUDA kernel's.
    return_lse: also return lse = m + log(l), (B, H, Lq) in the
    accumulation dtype (fp32 for bf16/fp32 inputs).
    """
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    acc_t = _acc_dtype(q.dtype)
    q = q * _scale(D, q.dtype, q.device)
    if block_k is None:
        lk_pad = _round_up(Lk, 128)
        block_k = lk_pad if lk_pad <= 2048 else 512
    lk_pad = _round_up(Lk, block_k)
    if lk_pad != Lk:
        pad = q.new_zeros((B, H, lk_pad - Lk, D))
        k = torch.cat([k, pad.to(k.dtype)], dim=2)
        v = torch.cat([v, pad.to(v.dtype)], dim=2)
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=acc_t, device=q.device)
    for i in range(lk_pad // block_k):
        kb = k[:, :, i * block_k:(i + 1) * block_k]
        vb = v[:, :, i * block_k:(i + 1) * block_k]
        s = _mm(q, kb.transpose(-1, -2), acc_t)
        if (i + 1) * block_k > Lk:  # the tile holding padded keys
            pos = i * block_k + torch.arange(block_k, device=q.device)
            s = s + torch.where(pos < Lk, 0.0, NEG_INF).to(acc_t)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new).to(v.dtype)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.to(acc_t).sum(dim=-1, keepdim=True)
        acc = acc * alpha + _mm(p, vb, acc_t)
        m = m_new
    o = (acc / l).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, g):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) from the
    forward's o and lse rows and the output gradient g, at the TPU
    kernel's rounding points, step by step:

        q_s = q · scale                 (in the input dtype)
        D   = rowsum(g ∘ o)             (fp32)
        s   = q_s · kᵀ                  (fp32 accumulation)
        p   = exp(s − lse)              (fp32)
        dv  = round(pᵀ) · g             (p rounded to v's dtype; fp32 sum, rounded once)
        dp  = g · vᵀ                    (fp32)
        ds  = round(p ∘ (dp − D))       (rounded to the input dtype)
        dk  = dsᵀ · q_s                 (fp32 sum, rounded once)
        dq  = round(ds · k) · scale     (the product in the input dtype)
    """
    D = q.shape[-1]
    acc_t = _acc_dtype(q.dtype)
    scale = _scale(D, q.dtype, q.device)
    qs = q * scale
    delta = (g.to(acc_t) * o.to(acc_t)).sum(dim=-1, keepdim=True)
    s = _mm(qs, k.transpose(-1, -2), acc_t)
    p = torch.exp(s - lse.to(acc_t)[..., None])
    dv = _mm(p.to(v.dtype).transpose(-1, -2), g, acc_t).to(v.dtype)
    dp = _mm(g, v.transpose(-1, -2), acc_t)
    ds = (p * (dp - delta)).to(q.dtype)
    dk = _mm(ds.transpose(-1, -2), qs, acc_t).to(k.dtype)
    dq = _mm(ds, k, acc_t).to(q.dtype) * scale
    return dq, dk, dv


def _check_operands(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-D (B, H, L, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"device mismatch: {q.device}, {k.device}, {v.device}")


def _check_kernel_operands(named):
    """The CUDA kernels take bf16/fp32, D = 64, unit stride over D and
    16-byte aligned rows."""
    dtype = named[0][1].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes bf16 or fp32, got {dtype}")
    D = named[0][1].shape[-1]
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim {KERNEL_HEAD_DIM}, got {D}")
    vec = 16 // named[0][1].element_size()  # elements per 16-byte vector load
    for name, t in named:
        st = t.stride()
        if st[3] != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride over D")
        if t.data_ptr() % 16 or st[0] % vec or st[1] % vec or st[2] % vec:
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned "
                             f"(strides {st})")


def _heads_last_empty(B, H, L, D, like):
    """(B, H, L, D) view of a (B, L, H, D) allocation: merge_heads of it is a
    view, and so is the head split of its gradient."""
    return torch.empty_strided((B, H, L, D), (L * H * D, D, H * D, 1), dtype=like.dtype,
                               device=like.device)


def _tma_operand(t):
    """The bf16 kernels read q, k, v (and the backward g) through TMA tensor
    maps, whose strides must be non-zero: an expanded (stride-0) dim is
    copied out."""
    st = t.stride()
    if 0 in st and t.dtype == torch.bfloat16 and any(
            s == 0 and n > 1 for s, n in zip(st, t.shape)):
        return t.contiguous()
    return t


def _fwd_args(q, k, v, o, lse, stream):
    """The forward C entry's arguments, in its order (lse None: no lse rows)."""
    B, H, Lq, D = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype], q.device.index,
            B, H, Lq, k.shape[2], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], _scale_value(D, q.dtype), stream)


def _launch(q, k, v, with_lse: bool = False):
    """Run the forward kernel on CUDA tensors (strided views accepted).
    Returns o, or (o, lse) with lse (B, H, Lq) fp32 when with_lse."""
    _check_kernel_operands((("q", q), ("k", k), ("v", v)))
    q, k, v = _tma_operand(q), _tma_operand(k), _tma_operand(v)
    B, H, Lq, D = q.shape
    o = _heads_last_empty(B, H, Lq, D, q)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _kernel_fns()["fwd"](*_fwd_args(q, k, v, o, lse,
                                           torch.cuda.current_stream(q.device).cuda_stream))
    name = "flash_attention_fwd_lse" if with_lse else "flash_attention_fwd"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launch_counts[name] += 1
    return (o, lse) if with_lse else o


# the backward kernels' (B*H, 2, Lq rounded up to this) fp32 scratch: a copy
# of the lse rows and Delta = rowsum(g * o), written by the dq kernel and
# read by the dk/dv kernel in 64-row tiles (csrc/flash_attention_bwd.cu)
KERNEL_STATS_ALIGN = 64


def _bwd_stats_empty(B, H, Lq, device):
    return torch.empty((B * H, 2, _round_up(Lq, KERNEL_STATS_ALIGN)), dtype=torch.float32,
                       device=device)


def _bwd_args(q, k, v, o, lse, g, stats, dq, dk, dv, stream):
    """The backward C entry's arguments, in its order."""
    B, H, Lq, D = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], q.device.index, B, H, Lq, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *g.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            _scale_value(D, q.dtype), stream)


def _launch_bwd(q, k, v, o, lse, g):
    """Run the backward kernels on CUDA tensors: (dq, dk, dv), each a
    (B, H, L, D) view of a (B, L, H, D) allocation."""
    if g.dtype != q.dtype:
        g = g.to(q.dtype)
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("g", g))
    if g.stride(3) != 1 or g.data_ptr() % 16 or any(s % (16 // g.element_size())
                                                    for s in g.stride()[:3]):
        g = g.contiguous()  # e.g. an expanded gradient of a sum
        named = named[:4] + (("g", g),)
    _check_kernel_operands(named)
    q, k, v, g = _tma_operand(q), _tma_operand(k), _tma_operand(v), _tma_operand(g)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    lse = lse.contiguous()
    stats = _bwd_stats_empty(B, H, Lq, q.device)
    dq = _heads_last_empty(B, H, Lq, D, q)
    dk = _heads_last_empty(B, H, Lk, D, k)
    dv = _heads_last_empty(B, H, Lk, D, v)
    err = _kernel_fns()["bwd"](*_bwd_args(q, k, v, o, lse, g, stats, dq, dk, dv,
                                          torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv


_fns: dict = {}


def _kernel_fns():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        _build.build_all(["flash_attention_fwd", "flash_attention_bwd"])  # nvcc in parallel
        fwd = _build.load("flash_attention_fwd").vidil_flash_attention_fwd
        fwd.restype = ctypes.c_int
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                        + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
        bwd = _build.load("flash_attention_bwd").vidil_flash_attention_bwd
        bwd.restype = ctypes.c_int
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                        + [ctypes.c_longlong] * 24 + [ctypes.c_float, ctypes.c_void_p])
        _fns.update(fwd=fwd, bwd=bwd)
    return _fns


def _forward(q, k, v, with_lse: bool):
    if q.is_cuda:
        return _launch(q, k, v, with_lse=with_lse)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, return_lse=with_lse)
    raise RuntimeError(f"flash_attention: no kernel for device {q.device}")


def _backward(q, k, v, o, lse, g):
    if q.is_cuda:
        return _launch_bwd(q, k, v, o, lse, g)
    return flash_attention_bwd_ref(q, k, v, o, lse, g.to(q.dtype))


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with its lse
    rows when a gradient will be taken (the plain forward otherwise), the
    backward kernel for the gradient. On CPU tensors both are the twins."""

    @staticmethod
    def forward(ctx, q, k, v, with_lse: bool):
        if not with_lse:
            return _forward(q, k, v, with_lse=False)
        o, lse = _forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable  # K2 records no graph: a double backward raises on every device
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, g)
        return dq, dk, dv, None


def flash_attention(q, k, v):
    """q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D) in q's dtype.

    CUDA tensors: the CUDA kernels (bf16 or fp32, D = 64). CPU tensors:
    the plain twins. Any other device raises. Differentiable in q, k, v.
    """
    _check_operands(q, k, v)
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttentionFunction.apply(q, k, v, with_lse)


# the TPU package's gate threshold (vidil_tpu/ops/flash_attention.py:53):
# fp32 logits of at least this many bytes
_LOGITS_SPILL_BYTES = 128 * 1024 * 1024


def _flash_profitable(q, k, bias, grid=(1, 1)) -> bool:
    """The TPU package's dispatch rule (``_flash_profitable``), as it is:
    no bias, Lq >= 128, a >= 512-long axis on either side, D <= 256 and
    fp32 logits of at least `_LOGITS_SPILL_BYTES`, read on the shape the
    JAX program sees: batch x ``grid[0]``, heads x ``grid[1]``."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    B, H = B * grid[0], H * grid[1]
    return (bias is None and Lq >= 128 and (Lq >= 512 or Lk >= 512)
            and q.shape[-1] <= 256
            and B * H * Lq * Lk * 4 >= _LOGITS_SPILL_BYTES)


def attention_auto(q, k, v, bias=None, use_flash: bool = True, grid=(1, 1)):
    """The reference's routing (``vidil_tpu/ops/flash_attention.py:
    attention_auto``): `flash_attention` (the kernels on CUDA tensors, the
    twins on the CPU, where the reference runs its kernel with
    ``interpret=True``) when `_flash_profitable` holds, else
    `dot_product_attention`.

    The gate is kept because it decides which rounding a call gets: the
    kernel rounds p = exp(s - m) before its row sum and P·V, key tile by
    key tile; the plain path casts the normalised probabilities. So,
    as for K3's 2048-row gate (``models/layers.py:mlp_auto``), a shape
    takes the function the reference computes for it. Whether this rule,
    measured on a TPU, is also the fastest one on an H100 is a separate
    question, left open (ROADMAP). ``use_flash=False`` (``ViTConfig.use_flash``)
    sends every shape to the plain path, as in the reference.

    ``grid`` = (data, model): the gate reads the shape of the JAX package's
    one program, whose train steps run over the global batch and every
    head. The four train steps pass their grid (`parallel/mesh.py:Grid.gate`)
    down through `vit_forward` and `med_forward`: a rank's batch times the
    data axis, its local heads times the model axis. Every other caller
    keeps (1, 1), because there the JAX counterpart also sees a chunk of
    its own: the inference CLIs whose ranks each take their own videos
    (CapFilt, visual tokenization), the evaluations, and the rank-sharded
    retrieval rerank.
    """
    if use_flash and _flash_profitable(q, k, bias, grid):
        return flash_attention(q, k, v)
    return dot_product_attention(q, k, v, bias=bias)
