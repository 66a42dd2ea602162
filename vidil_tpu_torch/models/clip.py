"""CLIP dual towers (the visual-tokenization encoder).

Counterpart of ``vidil_tpu/models/clip.py``, the same math as HF
``CLIPModel``: pre-LN transformer towers with quick_gelu, projection heads,
L2-normalised output embeddings. ``params["vision"]["layers"]`` and
``params["text"]["layers"]`` are lists of per-layer dicts; parameters come
from an HF state dict through ``convert.convert_clip``, from `init_clip`
(random, the JAX package's distributions) or from `clip_shapes` and
``utils/synth.py:synth_tree``.

Attention goes through `attention_auto`, with the JAX package's gate:
CLIP's 257-token vision sequences and the text tower's causal bias both
take the plain path (`dot_product_attention`), as in the reference.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import CLIPConfig
from vidil_tpu_torch.models.blip import _lin, _ln, _stacked
from vidil_tpu_torch.models.layers import (
    ACT2FN,
    embedding_lookup,
    init_embedding,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    merge_heads,
    normal,
    split_heads,
)
from vidil_tpu_torch.models.vit import patchify
from vidil_tpu_torch.ops.flash_attention import attention_auto


def _init_tower_layer(generator: torch.Generator, d: int, mlp: int, device=None):
    device = generator.device if device is None else device
    return {
        "norm1": init_layer_norm(d, device),
        "attn": {name: init_linear(generator, d, d, device=device)
                 for name in ("query", "key", "value", "out")},
        "norm2": init_layer_norm(d, device),
        "mlp": {"fc1": init_linear(generator, d, mlp, device=device),
                "fc2": init_linear(generator, mlp, d, device=device)},
    }


def init_clip(generator: torch.Generator, cfg: CLIPConfig, device=None):
    """Random CLIP parameters, the JAX package's distributions: linears and
    the token embedding truncated normal (std 0.02); the patch kernel, the
    class embedding, both position embeddings and both projections plain
    normal (std 0.02); LayerNorms ones and zeros; ``logit_scale`` 2.6592."""
    device = generator.device if device is None else device
    dv, dt = cfg.vision_hidden_size, cfg.text_hidden_size
    num_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    return {
        "vision": {
            "patch_embed": {"kernel": normal(generator, (cfg.patch_size ** 2 * 3, dv),
                                             device=device)},
            "class_embedding": normal(generator, (dv,), device=device),
            "pos_embed": normal(generator, (num_pos, dv), device=device),
            "pre_norm": init_layer_norm(dv, device),
            "layers": [_init_tower_layer(generator, dv, cfg.vision_intermediate_size, device)
                       for _ in range(cfg.vision_layers)],
            "post_norm": init_layer_norm(dv, device),
        },
        "text": {
            "token_embedding": init_embedding(generator, cfg.vocab_size, dt, device=device),
            "pos_embed": normal(generator, (cfg.max_text_len, dt), device=device),
            "layers": [_init_tower_layer(generator, dt, cfg.text_intermediate_size, device)
                       for _ in range(cfg.text_layers)],
            "final_norm": init_layer_norm(dt, device),
        },
        "visual_projection": {"kernel": normal(generator, (dv, cfg.projection_dim),
                                               device=device)},
        "text_projection": {"kernel": normal(generator, (dt, cfg.projection_dim),
                                             device=device)},
        "logit_scale": torch.tensor(2.6592, device=device),
    }


def _tower(layers, x, bias, num_heads: int, eps: float, act, dtype=None):
    """Pre-LN transformer stack shared by both towers."""
    for layer in layers:
        h = layer_norm(layer["norm1"], x, eps)
        q = split_heads(linear(layer["attn"]["query"], h, dtype=dtype), num_heads)
        k = split_heads(linear(layer["attn"]["key"], h, dtype=dtype), num_heads)
        v = split_heads(linear(layer["attn"]["value"], h, dtype=dtype), num_heads)
        ctx = merge_heads(attention_auto(q, k, v, bias=bias))
        x = x + linear(layer["attn"]["out"], ctx, dtype=dtype)
        h = layer_norm(layer["norm2"], x, eps)
        h = act(linear(layer["mlp"]["fc1"], h, dtype=dtype))
        x = x + linear(layer["mlp"]["fc2"], h, dtype=dtype)
    return x


def clip_vision_forward(params, images, cfg: CLIPConfig, dtype=None):
    """images (B, S, S, 3) preprocessed -> (last_hidden, pooled), pooled =
    post_layernorm(hidden[:, 0]) (HF CLIPVisionTransformer)."""
    p = params["vision"]
    B = images.shape[0]
    x = patchify(images, cfg.patch_size)
    kernel = p["patch_embed"]["kernel"]
    if dtype is not None:
        x, kernel = x.to(dtype), kernel.to(dtype)
    x = torch.matmul(x, kernel)
    cls = p["class_embedding"].to(x.dtype).expand(B, 1, cfg.vision_hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + p["pos_embed"].to(x.dtype)[None]
    x = layer_norm(p["pre_norm"], x, cfg.layer_norm_eps)
    x = _tower(p["layers"], x, None, cfg.vision_heads, cfg.layer_norm_eps,
               ACT2FN[cfg.hidden_act], dtype)
    pooled = layer_norm(p["post_norm"], x[:, 0], cfg.layer_norm_eps)
    return x, pooled


def clip_text_forward(params, input_ids, cfg: CLIPConfig, dtype=None):
    """input_ids (B, L) -> (last_hidden, pooled at the eot position). The
    pooled position is argmax(input_ids): eot has the largest id in the CLIP
    vocab, and the first of equal maxima is taken (pads are eot too)."""
    p = params["text"]
    B, L = input_ids.shape
    x = embedding_lookup(p["token_embedding"], input_ids)
    x = x + p["pos_embed"][:L][None]
    if dtype is not None:
        x = x.to(dtype)
    seq = torch.arange(L, device=input_ids.device)
    causal = torch.where(seq[None, :] <= seq[:, None], 0.0, float("-inf"))[None, None]
    x = _tower(p["layers"], x, causal, cfg.text_heads, cfg.layer_norm_eps,
               ACT2FN[cfg.hidden_act], dtype)
    x = layer_norm(p["final_norm"], x, cfg.layer_norm_eps)
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(B, device=x.device), eot]
    return x, pooled


def _project(pooled, kernel, normalize: bool):
    emb = torch.matmul(pooled, kernel.to(pooled.dtype))
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)
    return emb


def clip_image_embeds(params, images, cfg: CLIPConfig, dtype=None, normalize: bool = True):
    """CLIPModel image_embeds: the projected (and L2-normalised) pooled CLS."""
    _, pooled = clip_vision_forward(params, images, cfg, dtype=dtype)
    return _project(pooled, params["visual_projection"]["kernel"], normalize)


def clip_text_embeds(params, input_ids, cfg: CLIPConfig, dtype=None, normalize: bool = True):
    """CLIPModel text_embeds: the projected (and L2-normalised) eot state."""
    _, pooled = clip_text_forward(params, input_ids, cfg, dtype=dtype)
    return _project(pooled, params["text_projection"]["kernel"], normalize)


def clip_shapes(cfg: CLIPConfig) -> dict:
    """Parameter shapes in the JAX package's layout (stacked layer axis,
    (in, out) kernels), for ``utils/synth.py:synth_tree``."""
    def layer(d, m):
        return {"norm1": _ln(d),
                "attn": {"query": _lin(d, d), "key": _lin(d, d), "value": _lin(d, d),
                         "out": _lin(d, d)},
                "norm2": _ln(d), "mlp": {"fc1": _lin(d, m), "fc2": _lin(m, d)}}

    dv, dt = cfg.vision_hidden_size, cfg.text_hidden_size
    return {
        "vision": {
            "patch_embed": {"kernel": (cfg.patch_size * cfg.patch_size * 3, dv)},
            "class_embedding": (dv,),
            "pos_embed": ((cfg.image_size // cfg.patch_size) ** 2 + 1, dv),
            "pre_norm": _ln(dv),
            "layers": _stacked(cfg.vision_layers, layer(dv, cfg.vision_intermediate_size)),
            "post_norm": _ln(dv),
        },
        "text": {
            "token_embedding": {"embedding": (cfg.vocab_size, dt)},
            "pos_embed": (cfg.max_text_len, dt),
            "layers": _stacked(cfg.text_layers, layer(dt, cfg.text_intermediate_size)),
            "final_norm": _ln(dt),
        },
        "visual_projection": {"kernel": (dv, cfg.projection_dim)},
        "text_projection": {"kernel": (dt, cfg.projection_dim)},
        "logit_scale": (),
    }
