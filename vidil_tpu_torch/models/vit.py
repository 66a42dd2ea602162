"""Vision Transformer (BLIP visual encoder).

Counterpart of ``vidil_tpu/models/vit.py``: NHWC images, patchify with
(ph, pw, c) inner order and one matmul (the same math as a stride-P
Conv2d), [CLS] + learned position embedding, pre-LN blocks with GELU, and
a final LayerNorm. ``params["blocks"]`` is a list of per-layer dicts.

The self-attention goes through `attention_auto`: the Hopper flash kernel
on CUDA tensors, its plain twin on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from vidil_tpu_torch.config import ViTConfig
from vidil_tpu_torch.models.layers import (
    gelu,
    layer_norm,
    linear,
    merge_heads,
    mlp,
    remat,
    split_heads,
)
from vidil_tpu_torch.ops.flash_attention import attention_auto


def patchify(x, patch_size: int):
    """(B, H, W, C) -> (B, nH*nW, P*P*C) with (ph, pw, c) inner order."""
    B, H, W, C = x.shape
    P = patch_size
    nH, nW = H // P, W // P
    x = x.reshape(B, nH, P, nW, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nH * nW, P * P * C)


def attention(params, x, num_heads: int, dtype=None):
    """Fused-QKV self-attention; q, k, v reach the kernel as strided views
    of the QKV projection."""
    qkv = linear(params["qkv"], x, dtype=dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    out = attention_auto(q, k, v)
    return linear(params["proj"], merge_heads(out), dtype=dtype)


def block_forward(params, x, num_heads: int, eps: float, dtype=None):
    """Pre-LN residual block."""
    x = x + attention(params["attn"], layer_norm(params["norm1"], x, eps), num_heads, dtype=dtype)
    x = x + mlp(params["mlp"], layer_norm(params["norm2"], x, eps), act=gelu, dtype=dtype)
    return x


def vit_forward(params, images, cfg: ViTConfig, dtype=None):
    """images: (B, H, W, C) NHWC, already resized/normalized.
    Returns (B, num_patches + 1, hidden) embeddings (token 0 = [CLS]).

    The classic schedule: blocks one after another, each recomputed in the
    backward when ``cfg.remat`` (blocks from ``cfg.remat_from_layer`` on).
    The JAX package's fused-block schedule (its K4/K5 kernels) is not
    ported; ViTConfig refuses it."""
    B = images.shape[0]
    x = linear(params["patch_embed"], patchify(images, cfg.patch_size), dtype=dtype)
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][:, : x.shape[1], :].to(x.dtype)
    for i, blk in enumerate(params["blocks"]):
        fn = remat(block_forward, cfg.remat and i >= cfg.remat_from_layer)
        x = fn(blk, x, cfg.num_heads, cfg.layer_norm_eps, dtype)
    return layer_norm(params["norm"], x, cfg.layer_norm_eps)


def _torch_bicubic_weights(in_size: int, out_size: int):
    """1-D resampling weight matrix (out, in) matching
    ``torch.nn.functional.interpolate(mode='bicubic', align_corners=False)``:
    half-pixel coordinate mapping, cubic convolution kernel with a=-0.75,
    edge-clamped taps."""
    a = -0.75

    def kernel(s):
        s = np.abs(s)
        return np.where(s <= 1, (a + 2) * s**3 - (a + 3) * s**2 + 1,
                        np.where(s < 2, a * s**3 - 5 * a * s**2 + 8 * a * s - 4 * a, 0.0))

    scale = in_size / out_size
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(int)
    t = x - x0
    w = np.zeros((out_size, in_size), np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(x0 + tap, 0, in_size - 1)
        np.add.at(w, (np.arange(out_size), idx), kernel(tap - t))
    return w


def interpolate_pos_embed(pos_embed, new_num_patches: int, num_extra_tokens: int = 1):
    """Bicubic-resize a (1, extra + n*n, D) numpy position embedding to a
    new grid (the reference's ``F.interpolate(..., mode='bicubic')``). Host
    numpy, at checkpoint load."""
    pos_embed = np.asarray(pos_embed)
    old_len = pos_embed.shape[1] - num_extra_tokens
    orig_size = int(old_len**0.5)
    new_size = int(new_num_patches**0.5)
    if orig_size == new_size:
        return pos_embed
    extra = pos_embed[:, :num_extra_tokens]
    grid = np.asarray(pos_embed[:, num_extra_tokens:], np.float64).reshape(
        orig_size, orig_size, -1)
    w = _torch_bicubic_weights(orig_size, new_size)
    grid = np.einsum("oi,ijd->ojd", w, grid)   # rows
    grid = np.einsum("oj,ijd->iod", w, grid)   # cols
    grid = grid.reshape(1, new_size * new_size, -1).astype(pos_embed.dtype)
    return np.concatenate([extra, grid], axis=1)
