"""Fused transformer MLP (fc1 -> GELU -> fc2), forward: the hand-written
Hopper kernel, its plain version, and the autograd Function around it — the
counterpart of ``vidil_tpu/ops/fused_mlp.py``.

On CUDA tensors the forward launches ``csrc/fused_mlp_fwd.cu`` (the
counterpart of the TPU kernel ``_fused_mlp_forward``, K3); on CPU tensors it
runs the plain version `fused_mlp_ref`. Nothing falls back: a CUDA launch
that cannot run raises. There is no backward kernel (the TPU package has
none either): the gradient is autograd through a recompute of the plain
``models/layers.py:mlp``, with the cotangent cast to x's dtype, as
``_fused_mlp_vjp_bwd`` does.

Rounding points (``_mlp_kernel``): both products accumulate in fp32; b1 is
added in fp32 and GELU runs in fp32 on the unrounded sum, with the TPU
kernel's A&S 7.1.26 erf (max error 1.5e-7); the activation is rounded once
to x's dtype; b2 is added in fp32, then the result is rounded. This is not
K4's rounding (``ops/fused_vit_block.py`` rounds the fc1 output before
its GELU).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from vidil_tpu_torch.models.layers import mlp

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# launches of the CUDA kernel by this process (one per call), for showing
# that a run went through it; `reset_launch_counts` sets it to 0
launch_counts = {"fused_mlp_fwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# erf by Abramowitz & Stegun 7.1.26: the TPU kernel's (Pallas on a TPU has no
# lowering of lax.erf)
_AS_P = 0.3275911
_AS_A = (1.061405429, -1.453152027, 1.421413741, -0.284496736, 0.254829592)


def _erf_as(x):
    s = torch.sign(x)
    a = x.abs()
    t = 1.0 / (1.0 + _AS_P * a)
    poly = ((((_AS_A[0] * t + _AS_A[1]) * t + _AS_A[2]) * t + _AS_A[3]) * t + _AS_A[4]) * t
    return s * (1.0 - poly * torch.exp(-a * a))


def _gelu_as(h):
    """GELU with the A&S erf, in the dtype of `h` (fp32 in the kernel)."""
    return 0.5 * h * (1.0 + _erf_as(h * 0.7071067811865476))


def fused_mlp_ref(x, w1, b1, w2, b2):
    """Plain PyTorch version of the kernel (the TPU kernel's ``_mlp_kernel``
    line by line): x (..., D), w1 (D, Dm), b1 (Dm,), w2 (Dm, D), b2 (D,),
    all in x's dtype -> (..., D) in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    h = torch.matmul(x.to(acc), w1.to(acc)) + b1.to(acc)
    a = _gelu_as(h).to(x.dtype)
    o = torch.matmul(a.to(acc), w2.to(acc))
    return (o + b2.to(acc)).to(x.dtype)


def _check_kernel_operands(x, w1, b1, w2, b2):
    """The kernel takes bf16/fp32, one dtype and device for all five
    tensors, contiguous 16-byte-aligned operands (its tensor maps and
    vector stores), and D and the hidden width in multiples of 128."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp kernel takes bf16 or fp32, got {x.dtype}")
    D, Dm = x.shape[-1], w1.shape[-1]
    if D % 128 or Dm % 128:
        raise ValueError(f"fused_mlp kernel wants D and the hidden width in multiples of 128, "
                         f"got D={D}, Dm={Dm}")
    for t, want in ((w1, (D, Dm)), (b1, (Dm,)), (w2, (Dm, D)), (b2, (D,))):
        if tuple(t.shape) != want or t.dtype != x.dtype:
            raise ValueError(f"fused_mlp: weight {tuple(t.shape)} {t.dtype}, want {want} {x.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_mlp: weights must be contiguous, on x's device")
    if any(t.data_ptr() % 16 for t in (x, w1, b1, w2, b2)):
        raise ValueError("fused_mlp: x, the weights and the biases must be 16-byte aligned")
    return D, Dm


def _launch(x, w1, b1, w2, b2):
    """Run the kernel on CUDA tensors, rows flattened (any count: the
    kernel reads past the last row as zeros and stores none of it)."""
    x = x.contiguous()
    D, Dm = _check_kernel_operands(x, w1, b1, w2, b2)
    M = x.numel() // D
    act = torch.empty((M, Dm), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    if M == 0:
        return out
    err = _kernel_fn()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                       act.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], x.device.index,
                       M, D, Dm, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: cudaError {err}")
    launch_counts["fused_mlp_fwd"] += 1
    return out


_fns: dict = {}


def _kernel_fn():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        fn = _build.load("fused_mlp_fwd").vidil_fused_mlp_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _fns["fwd"] = fn
    return _fns["fwd"]


def _forward(x, w1, b1, w2, b2):
    if x.is_cuda:
        return _launch(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, b1, w2, b2)
    raise RuntimeError(f"fused_mlp: no kernel for device {x.device}")


class FusedMLPFunction(torch.autograd.Function):
    """Differentiable fused MLP: the forward kernel (its plain version on
    CPU tensors); the gradient is autograd through the plain `mlp` (the TPU
    package's ``_mlp_ref`` recompute), with the cotangent cast to x's
    dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors
        with torch.enable_grad():
            x, w1, b1, w2, b2 = leaves = [a.detach().requires_grad_(True) for a in args]
            out = mlp({"fc1": {"kernel": w1, "bias": b1}, "fc2": {"kernel": w2, "bias": b2}}, x)
            return torch.autograd.grad(out, leaves, g.to(x.dtype))


def fused_mlp(params, x):
    """Drop-in for ``layers.mlp(params, x)`` on inputs already cast to the
    compute dtype (``layers.mlp_auto`` casts them): params is
    {'fc1': {'kernel', 'bias'}, 'fc2': {...}}, x (..., D). CUDA tensors run
    the kernel, CPU tensors its plain version."""
    return FusedMLPFunction.apply(
        x, params["fc1"]["kernel"].contiguous(), params["fc1"]["bias"].contiguous(),
        params["fc2"]["kernel"].contiguous(), params["fc2"]["bias"].contiguous())
