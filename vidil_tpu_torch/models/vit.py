"""Vision Transformer (BLIP visual encoder).

Counterpart of ``vidil_tpu/models/vit.py``: NHWC images, patchify with
(ph, pw, c) inner order and one matmul (the same math as a stride-P
Conv2d), [CLS] + learned position embedding, pre-LN blocks with GELU, and
a final LayerNorm. ``params["blocks"]`` is a list of per-layer dicts.

The classic schedule runs the blocks one by one, the self-attention through
`attention_auto` (the reference's gate: the Hopper flash kernels on CUDA
tensors, or their plain twins on CPU tensors, where the logits would
spill, as at 384 px; `dot_product_attention` otherwise, as at 224 px),
and the MLP through `mlp_auto` (kernel K3 with
``ViTConfig.use_fused_mlp``). The fused-block schedule (``ViTConfig.use_fused_block``)
runs each block through `fused_vit_block` (kernels K4, and K5 for the
gradient with ``use_fused_block_bwd``).

Tensor parallelism (a `parallel/mesh.py:Grid` with a model axis, the
parameters sharded by `parallel/sharding.py:shard_params`): the classic
block on this rank's heads and hidden columns, Megatron's pattern: the
LayerNorm'd input enters the qkv and fc1 projections through
`copy_to_model`, the attention runs on the local heads, and proj and fc2
are row-parallel (`layers.row_linear`). The fused schedule runs each block
whole on every model rank, as the JAX package does (its kernel has no
sharding rule, so the partitioner gathers the block's weights): the
block's shards are gathered (`sharding.gather_block`), and each leaf's
gradient comes back as this rank's slice of the whole one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vidil_tpu_torch.config import ViTConfig
from vidil_tpu_torch.models.layers import (
    gelu,
    init_layer_norm,
    init_linear,
    init_mlp,
    layer_norm,
    linear,
    matmul_f32,
    merge_heads,
    mlp_auto,
    remat,
    row_linear,
    split_heads,
    tp_mlp,
    trunc_normal,
)
from vidil_tpu_torch.ops.flash_attention import attention_auto
from vidil_tpu_torch.ops.fused_vit_block import fused_vit_block


# ---------------------------------------------------------------------------
# init (the JAX package's distributions; models/layers.py)
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, dim: int, mlp_hidden: int, device=None):
    device = generator.device if device is None else device
    return {
        "norm1": init_layer_norm(dim, device),
        "attn": {"qkv": init_linear(generator, dim, 3 * dim, device=device),
                 "proj": init_linear(generator, dim, dim, device=device)},
        "norm2": init_layer_norm(dim, device),
        "mlp": init_mlp(generator, dim, mlp_hidden, device=device),
    }


def init_vit(generator: torch.Generator, cfg: ViTConfig, device=None):
    """Random ViT parameters: linears, ``cls_token`` and ``pos_embed``
    truncated normal (std 0.02), LayerNorms ones and zeros; the patch
    kernel (P*P*C, D) in patchify's order, as the JAX package lays it."""
    device = generator.device if device is None else device
    d = cfg.hidden_size
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_channels
    return {
        "patch_embed": init_linear(generator, patch_dim, d, device=device),
        "cls_token": trunc_normal(generator, (1, 1, d), device=device),
        "pos_embed": trunc_normal(generator, (1, cfg.seq_len, d), device=device),
        "blocks": [init_block(generator, d, int(d * cfg.mlp_ratio), device)
                   for _ in range(cfg.num_layers)],
        "norm": init_layer_norm(d, device),
    }


def patchify(x, patch_size: int):
    """(B, H, W, C) -> (B, nH*nW, P*P*C) with (ph, pw, c) inner order."""
    B, H, W, C = x.shape
    P = patch_size
    nH, nW = H // P, W // P
    x = x.reshape(B, nH, P, nW, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nH * nW, P * P * C)


def attention(params, x, num_heads: int, dtype=None, use_flash: bool = True, grid=None):
    """Fused-QKV self-attention; q, k, v reach the kernel as strided views
    of the QKV projection. ``use_flash=False`` keeps plain attention.
    Under `grid`'s model axis the qkv columns are this rank's heads and
    proj is row-parallel; the gate reads the grid's global shape."""
    tp = grid is not None and grid.tensor_parallel
    if tp:
        from vidil_tpu_torch.parallel.collectives import copy_to_model

        x = copy_to_model(x, grid.model_group)
        num_heads //= grid.model
    qkv = linear(params["qkv"], x, dtype=dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    out = attention_auto(q, k, v, use_flash=use_flash,
                         grid=grid.gate if grid is not None else (1, 1))
    if tp:
        return row_linear(params["proj"], merge_heads(out), grid.model_group, dtype=dtype)
    return linear(params["proj"], merge_heads(out), dtype=dtype)


def block_forward(params, x, num_heads: int, eps: float, dtype=None,
                  use_fused_mlp: bool = False, use_flash: bool = True, grid=None):
    """Pre-LN residual block; the MLP goes through `mlp_auto` (kernel K3
    when `use_fused_mlp` and its gate allow), or `tp_mlp` under `grid`'s
    model axis."""
    x = x + attention(params["attn"], layer_norm(params["norm1"], x, eps), num_heads, dtype=dtype,
                      use_flash=use_flash, grid=grid)
    h = layer_norm(params["norm2"], x, eps)
    if grid is not None and grid.tensor_parallel:
        return x + tp_mlp(params["mlp"], h, grid.model_group, act=gelu, dtype=dtype)
    return x + mlp_auto(params["mlp"], h, act=gelu, dtype=dtype, use_fused=use_fused_mlp)


def use_fused_schedule(cfg: ViTConfig, x) -> bool:
    """The fused-block gate of the JAX package's vit_forward: asked for,
    not under a remat that the forward-only kernel cannot serve (the
    fwd+bwd pair is its own remat), a 128-multiple width, and on the card
    (or `fused_block_interpret`, which runs the twins on the CPU). The
    32-wide test configs stay on the classic schedule."""
    return (cfg.use_fused_block and (not cfg.remat or cfg.use_fused_block_bwd)
            and cfg.hidden_size % 128 == 0 and (cfg.fused_block_interpret or x.is_cuda))


def _forward_with_attn(params, x, cfg: ViTConfig, dtype=None):
    """The classic blocks with each layer's softmax maps kept: the logits
    of an fp32-accumulated q·k product, scaled, softmax in fp32 (so no
    flash kernel: the probabilities are the output); the MLP through
    `mlp_auto` (K3 with ``use_fused_mlp``). Returns (x after the final
    LayerNorm, [(B, H, L, L) fp32 per layer])."""
    attns = []
    for blk in params["blocks"]:
        h = layer_norm(blk["norm1"], x, cfg.layer_norm_eps)
        qkv = linear(blk["attn"]["qkv"], h, dtype=dtype)
        q, k, v = (split_heads(t, cfg.num_heads) for t in qkv.chunk(3, dim=-1))
        logits = matmul_f32(q, k.transpose(-1, -2))
        probs = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
        attns.append(probs)
        out = torch.matmul(probs.to(v.dtype), v)
        x = x + linear(blk["attn"]["proj"], merge_heads(out), dtype=dtype)
        x = x + mlp_auto(blk["mlp"], layer_norm(blk["norm2"], x, cfg.layer_norm_eps),
                         dtype=dtype, use_fused=cfg.use_fused_mlp)
    return layer_norm(params["norm"], x, cfg.layer_norm_eps), attns


def vit_forward(params, images, cfg: ViTConfig, dtype=None, return_attn: bool = False,
                grid=None):
    """images: (B, H, W, C) NHWC, already resized/normalized.
    Returns (B, num_patches + 1, hidden) embeddings (token 0 = [CLS]), and
    with ``return_attn`` also every layer's attention maps (the
    reference's save_attention_map), `_forward_with_attn`.

    Fused schedule (`use_fused_schedule`): the token axis is padded once to
    a multiple of 128, every block runs as `fused_vit_block` on the padded
    array (pad keys masked, pad rows garbage that stays finite), then the
    pad is sliced off before the final LayerNorm. Under
    ``use_fused_block_bwd`` the backward kernel recomputes each block from
    its input, so nothing wraps it in a checkpoint.
    Classic schedule: blocks one after another, each recomputed in the
    backward when ``cfg.remat`` (blocks from ``cfg.remat_from_layer`` on;
    all of it, or all but the GEMM outputs under ``remat_policy: dots``).

    grid: the train steps' (data, model) grid (`parallel/mesh.py:Grid`):
    the attention gate reads the step's global shape, and a model axis runs
    the classic blocks tensor-parallel on sharded parameters, or each fused
    block whole on the gathered ones."""
    B = images.shape[0]
    x = linear(params["patch_embed"], patchify(images, cfg.patch_size), dtype=dtype)
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"][:, : x.shape[1], :].to(x.dtype)
    if return_attn:
        return _forward_with_attn(params, x, cfg, dtype)
    tp = grid is not None and grid.tensor_parallel
    if use_fused_schedule(cfg, x):
        from vidil_tpu_torch.parallel.sharding import gather_block

        L = x.shape[1]
        lp = (L + 127) // 128 * 128
        x = F.pad(x, (0, 0, 0, lp - L))
        for blk in params["blocks"]:
            if tp:
                blk = gather_block(blk, grid.model_group)
            x = fused_vit_block(blk, x, cfg.num_heads, cfg.layer_norm_eps, true_len=L,
                                frames_per_program=cfg.fused_block_frames,
                                pallas_bwd=cfg.use_fused_block_bwd,
                                bwd_frames=cfg.fused_block_bwd_frames)
        return layer_norm(params["norm"], x[:, :L], cfg.layer_norm_eps)
    for i, blk in enumerate(params["blocks"]):
        fn = remat(block_forward, cfg.remat and i >= cfg.remat_from_layer, cfg.remat_policy)
        x = fn(blk, x, cfg.num_heads, cfg.layer_norm_eps, dtype, cfg.use_fused_mlp, cfg.use_flash,
               grid)
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
