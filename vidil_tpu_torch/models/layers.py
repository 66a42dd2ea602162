"""Transformer primitives shared by the ViT and MED towers.

Plain functions on tensors. Parameters are nested dicts of tensors with
the JAX package's names and layouts: a linear's ``kernel`` is
``(in_features, out_features)`` and ``y = x @ kernel + bias``.

Precision policy (the same as the JAX package's): pass ``dtype`` to run
a linear in that dtype (x, kernel and bias are all cast, the product is
rounded to the dtype and the bias is added in it); LayerNorm statistics,
attention logits and softmax are always fp32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" policy's rule: keep the plain GEMMs' outputs (``aten.mm``
    and ``aten.addmm``: the linears, whose products carry no batch
    dimension), recompute the batched products (``bmm``/``baddbmm``: the
    attention's) and the elementwise ops."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name):
    """Resolve a config ``remat_policy`` to a checkpoint ``context_fn``:
    None recomputes the whole layer in the backward (the JAX package's
    classic remat); "dots" is JAX's ``dots_with_no_batch_dims_saveable``,
    a selective checkpoint (`create_selective_checkpoint_contexts`) that
    saves the plain GEMM outputs and recomputes the rest (`_dots_policy`),
    trading memory for the GEMM recompute."""
    if name is None:
        return None
    if name == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    raise ValueError(f"unknown remat_policy: {name!r}")


def remat(fn, enabled: bool, policy=None):
    """`fn` with its activations recomputed in the backward when `enabled`
    (torch.utils.checkpoint, non-reentrant: the same numbers, less memory),
    all of them, or all but what the named `policy` saves (`remat_policy`)."""
    if not enabled:
        return fn
    context_fn = remat_policy(policy)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# initializers: the JAX package's distributions, drawn from a torch.Generator
# on `device` (the generator's device when None); fp32 leaves
# ---------------------------------------------------------------------------

# erf(-sqrt 2), erf(sqrt 2): the uniform range whose inverse-CDF image is (-2, 2)
_TRUNC_U = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))


def trunc_normal(generator: torch.Generator, shape, std: float = 0.02, device=None):
    """A normal of scale `std` truncated to (-2*std, 2*std), as the JAX
    package's `trunc_normal` (timm's trunc_normal_): uniform draws mapped
    through the inverse CDF, the method of jax.random.truncated_normal, and
    clamped to the bounds. Sample std 0.8796 * std. (torch.nn.init.
    trunc_normal_'s default bounds are -2 and 2 absolute, which at std 0.02
    truncate nothing.)"""
    device = generator.device if device is None else device
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(*_TRUNC_U, generator=generator)
    return u.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def normal(generator: torch.Generator, shape, std: float = 0.02, device=None):
    """A plain normal of scale `std` (the JAX package's ``std *
    jax.random.normal``)."""
    device = generator.device if device is None else device
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int, std: float = 0.02,
                device=None):
    """{kernel (in, out) truncated normal, bias zeros}."""
    kernel = trunc_normal(generator, (in_dim, out_dim), std, device)
    return {"kernel": kernel, "bias": torch.zeros(out_dim, device=kernel.device)}


def init_layer_norm(dim: int, device="cpu"):
    return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}


def init_embedding(generator: torch.Generator, num: int, dim: int, std: float = 0.02,
                   device=None):
    return {"embedding": trunc_normal(generator, (num, dim), std, device)}


def init_mlp(generator: torch.Generator, dim: int, hidden_dim: int, std: float = 0.02,
             device=None):
    return {"fc1": init_linear(generator, dim, hidden_dim, std, device),
            "fc2": init_linear(generator, hidden_dim, dim, std, device)}


def linear(params, x, dtype=None):
    kernel = params["kernel"]
    bias = params["bias"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
        bias = bias.to(dtype)
    # product and bias add are two roundings, as in the JAX package's
    # jnp.dot(x, kernel) + bias (F.linear would fuse the add into one)
    return torch.matmul(x, kernel) + bias


def row_linear(params, x, group, dtype=None):
    """A row-parallel linear over the model group: x holds this rank's
    input columns and ``kernel`` the matching rows. The partial product is
    kept in fp32 (the same sums as a bf16 tensor-core product with fp32
    accumulation, `matmul_f32`), summed over the group
    (`reduce_from_model`), rounded to `dtype` once, as the one-process
    product is, and the replicated bias is added once, after the sum."""
    from vidil_tpu_torch.parallel.collectives import reduce_from_model

    kernel = params["kernel"]
    bias = params["bias"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
        bias = bias.to(dtype)
    return reduce_from_model(matmul_f32(x, kernel), group).to(x.dtype) + bias


def layer_norm(params, x, eps: float = 1e-6):
    """LayerNorm with fp32 statistics regardless of input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU — torch.nn.GELU / HF 'gelu'."""
    return F.gelu(x, approximate="none")


def quick_gelu(x):
    """x * sigmoid(1.702 x) — OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN = {"gelu": gelu, "quick_gelu": quick_gelu}


def embedding_lookup(params, ids):
    return params["embedding"][ids]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def split_heads(x, num_heads: int):
    """(..., L, H*Dh) -> (..., H, L, Dh), a strided view."""
    *lead, L, D = x.shape
    return x.reshape(*lead, L, num_heads, D // num_heads).transpose(-3, -2)


def merge_heads(x):
    """(..., H, L, Dh) -> (..., L, H*Dh)"""
    x = x.transpose(-3, -2)
    *lead, L, H, Dh = x.shape
    return x.reshape(*lead, L, H * Dh)


def matmul_f32(a, b):
    """a @ b with fp32 accumulation and an fp32 result, the counterpart of
    jnp.einsum(..., preferred_element_type=jnp.float32). A bf16 x bf16
    product is exact in fp32, so upcasting the operands computes the same
    sums as a bf16 tensor-core product with fp32 accumulation."""
    if a.dtype != torch.float32:
        a = a.float()
    if b.dtype != torch.float32:
        b = b.float()
    return torch.matmul(a, b)


def dot_product_attention(q, k, v, bias=None, scale=None):
    """Softmax attention with fp32 logits/softmax.

    q: (..., H, Lq, Dh), k/v: (..., H, Lk, Dh), bias broadcastable to
    (..., H, Lq, Lk), additive (0 to attend, large negative to mask).
    The scale is applied to the fp32 logits; probabilities are cast to
    v's dtype before the P·V product.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = matmul_f32(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def grouped_softmax_attention(q, k, v, bias, group_size: int):
    """`dot_product_attention` where ``group_size`` query rows share one K/V
    batch row: the groups become a broadcast dim of the two products (no
    K/V replication); fp32 logits, the context in v's dtype. q: (B*G, H, L,
    Dh), k/v: (B, H, Lk, Dh), bias None or broadcastable to (B, H, L, Lk)."""
    Bn, H, L, Dh = q.shape
    q5 = q.reshape(Bn // group_size, group_size, H, L, Dh)
    logits = _grouped_scores(q5, k) * (1.0 / math.sqrt(Dh))
    if bias is not None:
        logits = logits + bias[:, None].float()
    probs = torch.softmax(logits, dim=-1)
    return _grouped_context(probs.to(v.dtype), v).reshape(Bn, H, L, Dh)


def _grouped_scores(q5, k):
    """einsum('bnhqd,bhkd->bnhqk') with fp32 accumulation; the group axis
    folds into the query rows of one batched product."""
    B, G, H, L, Dh = q5.shape
    qf = q5.permute(0, 2, 1, 3, 4).reshape(B, H, G * L, Dh)
    s = matmul_f32(qf, k.transpose(-1, -2))  # (B, H, G*L, Lk)
    return s.reshape(B, H, G, L, -1).permute(0, 2, 1, 3, 4)


def _grouped_context(p5, v):
    """einsum('bnhqk,bhkd->bnhqd') in v's dtype."""
    B, G, H, L, Lk = p5.shape
    pf = p5.permute(0, 2, 1, 3, 4).reshape(B, H, G * L, Lk)
    ctx = torch.matmul(pf, v)  # (B, H, G*L, Dh)
    return ctx.reshape(B, H, G, L, -1).permute(0, 2, 1, 3, 4)


def mask_to_bias(mask, dtype=torch.float32, neg: float = -10000.0):
    """{0,1} attention mask -> additive bias, the reference's
    ``(1 - mask) * -10000``."""
    return ((1.0 - mask.float()) * neg).to(dtype)


def mlp(params, x, act=gelu, dtype=None):
    """fc1 -> act -> fc2."""
    h = linear(params["fc1"], x, dtype=dtype)
    h = act(h)
    return linear(params["fc2"], h, dtype=dtype)


def tp_mlp(params, x, group, act=gelu, dtype=None):
    """The MLP over the model group: fc1 column-parallel (this rank's hidden
    columns, its input through `copy_to_model`), fc2 row-parallel
    (`row_linear`)."""
    from vidil_tpu_torch.parallel.collectives import copy_to_model

    h = act(linear(params["fc1"], copy_to_model(x, group), dtype=dtype))
    return row_linear(params["fc2"], h, group, dtype=dtype)


# The JAX package's gate (measured there on a TPU, v5e): the fused kernel at
# >= 2048 flattened rows, the plain MLP below. The two take different
# rounding points (the kernel's GELU runs in fp32 on the unrounded fc1
# output), so the gate is part of what `use_fused_mlp` means and is kept as
# it is; whether another row threshold is faster on an H100 is open.
_FUSED_MLP_MIN_ROWS = 2048
_FUSED_MLP_MAX_WEIGHT_BYTES = 64 * 1024 * 1024


def mlp_auto(params, x, act=gelu, dtype=None, use_fused: bool = False,
             interpret: bool = False):
    """mlp() with the JAX package's dispatch to the fused MLP kernel
    (``ops/fused_mlp.py``, K3): fused only when asked for, for an exact-GELU
    MLP with >= _FUSED_MLP_MIN_ROWS flattened rows whose two weights fit in
    64 MB, on a CUDA tensor. `interpret` lifts the device condition, so a
    CPU tensor runs the kernel's plain version (the tests' route). x and the
    weights are cast to `dtype` before the call."""
    rows = x.numel() // x.shape[-1]
    k1 = params["fc1"]["kernel"]
    itemsize = dtype.itemsize if dtype is not None else k1.element_size()
    if (use_fused and act is gelu and rows >= _FUSED_MLP_MIN_ROWS
            and 2 * k1.numel() * itemsize <= _FUSED_MLP_MAX_WEIGHT_BYTES
            and (interpret or x.is_cuda)):
        from vidil_tpu_torch.ops.fused_mlp import fused_mlp

        if dtype is not None:
            params = {name: {k: v.to(dtype) for k, v in lin.items()}
                      for name, lin in params.items()}
            x = x.to(dtype)
        return fused_mlp(params, x)
    return mlp(params, x, act=act, dtype=dtype)


def cast_linears(tree, dtype):
    """Copy of a parameter tree whose linear kernels and biases are cast to
    `dtype` once, so that `linear(..., dtype)` finds them already cast.
    Numerically a no-op (linear casts to the same dtype); everything that
    is not a linear (LayerNorm, embeddings, tokens) keeps its dtype."""
    if dtype is None:
        return tree
    if isinstance(tree, list):
        return [cast_linears(t, dtype) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if "kernel" in tree:
        return {k: (v.to(dtype) if k in ("kernel", "bias") else v) for k, v in tree.items()}
    return {k: cast_linears(v, dtype) for k, v in tree.items()}
