"""The experts' grouped GEMM (kernel K7): the hand-written Hopper kernel,
its plain version, and its launch count.

`grouped_expert_gemm(x, w, offsets, relu2)` computes, for every expert e,
``out[o_e:o_{e+1}] = x[o_e:o_{e+1}] . w[e]^T`` where x (R, K) holds the
routed rows sorted by expert, w (E, N, K) every expert's weight and
offsets (E + 1,) int32 the row where each expert's rows start, on the
device: no host ever reads how many rows an expert has, so the call
enqueues without a sync and a CUDA graph can capture it. With ``relu2``
the epilogue applies the experts' activation, relu(.)^2 (the up
projection); without, it stores the sum (the down projection). On CUDA
tensors it launches ``csrc/grouped_expert_gemm.cu``, which replaces no TPU
kernel (the JAX package runs no mixture of experts); on CPU tensors the
plain version `grouped_expert_gemm_ref`. Nothing falls back: a CUDA launch
that cannot run raises.

Rounding points (the plain version's): bf16 operands, float32 sums, the
activation on the float32 sum, one rounding to bf16.

`experts_read(device)`: a device counter that a launch of fewer than
`SMALL_ROWS` rows adds to, once for each expert with rows: the expert
weights the decode has read, for the roofline of its launches, which their
bytes bound (`portbench/flops_lm.py`). Larger launches, which their
operations bound, count nothing.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel by this process (one per call; a replayed CUDA
# graph adds none), for showing that a run went through it
launch_counts = {"grouped_expert_gemm": 0}
# below this many rows a launch reads more weight bytes than the card can
# compute on at its bf16 rate (989 TFLOP/s over 3.35 TB/s: ~295 rows an
# expert), at or above 128 experts' worth it computes more than it reads
SMALL_ROWS = 295 * 128
_counters: dict = {}


def experts_read(device) -> torch.Tensor:
    """The (1,) int64 counter of experts read on `device` (see the module's
    docstring); made at its first use, which precedes any capture."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _counters:
        _counters[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _counters[device]


def grouped_expert_gemm_ref(x, w, offsets, relu2: bool = False):
    """Plain PyTorch version: a loop over the experts."""
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            acc = x[lo:hi].float() @ w[e].float().t()
            if relu2:
                acc = torch.relu(acc).square()
            out[lo:hi] = acc.to(x.dtype)
    return out


def check_kernel_operands(x, w, offsets):
    """What the kernel takes, raised otherwise: bf16 x (R, K) and w (E, N,
    K), contiguous, on one card; K a multiple of 64 and N of 8; int32
    offsets (E + 1,) on the same card."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"grouped_expert_gemm kernel takes bf16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != x.shape[1]:
        raise ValueError(f"grouped_expert_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}")
    R, K = x.shape
    E, N = w.shape[0], w.shape[1]
    if K % 64 or N % 8 or R < 1:
        raise ValueError(f"grouped_expert_gemm kernel takes K % 64 == 0, N % 8 == 0, got "
                         f"R {R}, N {N}, K {K}")
    if offsets.dtype != torch.int32 or offsets.shape != (E + 1,):
        raise ValueError("grouped_expert_gemm: offsets must be int32 of shape (E + 1,)")
    for t in (w, offsets):
        if t.device != x.device:
            raise ValueError("grouped_expert_gemm: x, w and offsets must share a device")
    if not (x.is_contiguous() and w.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("grouped_expert_gemm: operands must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_expert_gemm: operands must be 16-byte aligned")
    return R, N, K, E


def _launch(x, w, offsets, relu2: bool):
    R, N, K, E = check_kernel_operands(x, w, offsets)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    counter = experts_read(x.device).data_ptr() if R < SMALL_ROWS else None
    err = _kernel_fn()(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                       counter, x.device.index, R, N, K, E, int(relu2),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_expert_gemm launch failed: cudaError {err}")
    launch_counts["grouped_expert_gemm"] += 1
    return out


_fns: dict = {}


def _kernel_fn():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        fn = _build.load("grouped_expert_gemm").vidil_grouped_expert_gemm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        _fns["fwd"] = fn
    return _fns["fwd"]


def grouped_expert_gemm(x, w, offsets, relu2: bool = False):
    """x (R, K) rows sorted by expert, w (E, N, K), offsets (E + 1,) int32
    -> (R, N) in x's dtype (see the module's docstring). CUDA tensors run
    the kernel, CPU tensors its plain version."""
    if x.is_cuda:
        return _launch(x, w, offsets, relu2)
    if x.device.type == "cpu":
        return grouped_expert_gemm_ref(x, w, offsets, relu2)
    raise RuntimeError(f"grouped_expert_gemm: no kernel for device {x.device}")
