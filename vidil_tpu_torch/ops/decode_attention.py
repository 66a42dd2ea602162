"""The decode's cross-attention over a precomputed memory (kernel K6): the
hand-written Hopper kernel, its plain version, and its launch count.

`decode_cross_attention(q, k, v, group_size)` computes softmax(q·kᵀ/√Dh)·v
where ``group_size`` query rows share one memory row and nothing is masked:
the cross-attention of a decode step or prefill (`models/med.py:
_attn_block_precomputed_kv`). On CUDA tensors it launches
``csrc/decode_cross_attention.cu``, which replaces no TPU kernel (the JAX
package leaves this product to XLA): it reads each memory row's K and V once,
where the plain path upcasts and copies them. On CPU tensors it runs the
plain version `decode_cross_attention_ref`. Nothing falls back: a CUDA launch
that cannot run raises.

Rounding points (the plain version's, `models/layers.py:grouped_softmax_attention`):
fp32 logits, scaled by 1/√Dh after the product; an fp32 softmax over all
keys; the probabilities rounded to v's dtype; the product with v accumulated
in fp32 and rounded once to v's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vidil_tpu_torch.models.layers import grouped_softmax_attention, merge_heads, split_heads

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (32, 64, 128)
# query rows one block owns (kRows in the source): its logits (4 x Lk fp32),
# or its warps' partial sums (4 x 4 x Dh), and its queries (4 x Dh) sit in
# shared memory, 227 KB at most
KERNEL_ROWS = 4
_SMEM_BYTES = 227 * 1024


def kernel_smem_bytes(Lk: int, Dh: int) -> int:
    """Shared memory of one block."""
    return 4 * KERNEL_ROWS * (max(Lk, 4 * Dh) + Dh)


# launches of the CUDA kernel by this process (one per call), for showing
# that a run went through it; `reset_launch_counts` sets it to 0
launch_counts = {"decode_cross_attention": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def decode_cross_attention_ref(q, k, v, group_size: int):
    """Plain PyTorch version: q (B*G, L, H*Dh), k and v (B, H, Lk, Dh) ->
    (B*G, L, H*Dh) in v's dtype; the G query rows of a memory row fold into
    one (B, H, G*L, Dh) product (`grouped_softmax_attention`)."""
    return merge_heads(grouped_softmax_attention(split_heads(q, k.shape[1]), k, v, None,
                                                 group_size))


def check_kernel_operands(q, k, v, group_size: int):
    """What the kernel takes, raised otherwise: bf16 or fp32, one dtype and
    device; q (B*G, L, H*Dh) contiguous; k and v (B, H, Lk, Dh) with unit
    stride over Dh and 16-byte-aligned rows; Dh in KERNEL_HEAD_DIMS; a
    block's shared memory within 227 KB (`kernel_smem_bytes`)."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_cross_attention kernel takes bf16 or fp32, got {q.dtype}")
    if k.dim() != 4 or v.shape != k.shape or q.dim() != 3:
        raise ValueError(f"decode_cross_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, Lk, Dh = k.shape
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_cross_attention kernel takes Dh in {KERNEL_HEAD_DIMS}, got {Dh}")
    if group_size < 1 or q.shape[0] != B * group_size or q.shape[2] != H * Dh or Lk < 1:
        raise ValueError(f"decode_cross_attention: q {tuple(q.shape)} for {group_size} rows "
                         f"of k {tuple(k.shape)}")
    if kernel_smem_bytes(Lk, Dh) > _SMEM_BYTES:
        raise ValueError(f"decode_cross_attention: {Lk} keys exceed a block's shared memory")
    vec = 16 // q.element_size()
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("decode_cross_attention: q, k and v must share dtype and device")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("decode_cross_attention: k and v need unit stride over Dh and "
                             "16-byte-aligned rows")
    if not q.is_contiguous():
        raise ValueError("decode_cross_attention: q must be contiguous")
    return B, H, Lk, Dh


def _launch(q, k, v, group_size: int):
    B, H, Lk, Dh = check_kernel_operands(q, k, v, group_size)
    L = q.shape[1]
    out = torch.empty_like(q)
    err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       _DTYPE_CODE[q.dtype], q.device.index, B, group_size, L, H, Lk, Dh,
                       *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(Dh),
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_cross_attention launch failed: cudaError {err}")
    launch_counts["decode_cross_attention"] += 1
    return out


_fns: dict = {}


def _kernel_fn():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        fn = _build.load("decode_cross_attention").vidil_decode_cross_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        _fns["fwd"] = fn
    return _fns["fwd"]


def decode_cross_attention(q, k, v, group_size: int = 1):
    """softmax(q·kᵀ/√Dh)·v with ``group_size`` query rows a memory row: q the
    query projection's output (B*G, L, H*Dh), k and v one layer's
    precomputed memory (B, H, Lk, Dh), head-split views read in place.
    Returns (B*G, L, H*Dh), the layout the out projection reads. CUDA
    tensors run the kernel, CPU tensors its plain version."""
    if q.is_cuda:
        return _launch(q.contiguous(), k, v, group_size)
    if q.device.type == "cpu":
        return decode_cross_attention_ref(q, k, v, group_size)
    raise RuntimeError(f"decode_cross_attention: no kernel for device {q.device}")
