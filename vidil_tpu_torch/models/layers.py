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

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def remat_policy(name):
    """Resolve a config ``remat_policy``: None recomputes the whole layer in
    the backward (the JAX package's classic remat). The JAX package's
    "dots" policy (save the plain GEMM outputs) is not ported yet."""
    if name is None:
        return None
    if name == "dots":
        raise NotImplementedError("vidil_tpu_torch: remat_policy='dots' is not ported yet")
    raise ValueError(f"unknown remat_policy: {name!r}")


def remat(fn, enabled: bool):
    """`fn` with its activations recomputed in the backward when `enabled`
    (torch.utils.checkpoint, non-reentrant: the same numbers, less memory;
    the configs admit only the full-recompute policy, see `remat_policy`)."""
    if not enabled:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


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


def layer_norm(params, x, eps: float = 1e-6):
    """LayerNorm with fp32 statistics regardless of input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU — torch.nn.GELU / HF 'gelu'."""
    return F.gelu(x, approximate="none")


ACT2FN = {"gelu": gelu}


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


def mask_to_bias(mask, dtype=torch.float32, neg: float = -10000.0):
    """{0,1} attention mask -> additive bias, the reference's
    ``(1 - mask) * -10000``."""
    return ((1.0 - mask.float()) * neg).to(dtype)


def mlp(params, x, act=gelu, dtype=None):
    """fc1 -> act -> fc2."""
    h = linear(params["fc1"], x, dtype=dtype)
    h = act(h)
    return linear(params["fc2"], h, dtype=dtype)


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
