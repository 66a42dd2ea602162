"""BLIP NLVR2: the two-image reasoning head.

Counterpart of ``vidil_tpu/models/blip_nlvr.py``: each text-encoder layer
cross-attends both images with one shared attention core (query, key,
value) and twin output denses; below ``fusion_layer`` the two streams are
averaged, from it on they are concatenated and merged by a linear.
Classification is a two-layer ReLU head on [CLS]. ``params["nlvr"]`` is a
list of per-layer dicts {dense0, dense1, merge} (`blip_nlvr_shapes` in
models/blip.py gives the JAX layout for synthetic weights).
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import (
    dot_product_attention,
    gelu,
    init_linear,
    layer_norm,
    linear,
    merge_heads,
    split_heads,
)
from vidil_tpu_torch.models.vit import init_vit, vit_forward


def init_blip_nlvr(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                   fusion_layer: int = 6, device=None):
    """Random NLVR2 parameters (the JAX package's distributions): the ViT,
    the text encoder, the classification head and, per layer, the twin
    cross-attention output denses (d -> d) and the merge (2d -> d).
    `fusion_layer` is taken for the JAX signature; the tree is the same for
    every value."""
    device = generator.device if device is None else device
    d = med_cfg.hidden_size
    return {
        "visual_encoder": init_vit(generator, vit_cfg, device),
        "text_encoder": M.init_med(generator, med_cfg, device=device),
        "cls_head": {"fc1": init_linear(generator, d, d, device=device),
                     "fc2": init_linear(generator, d, 2, device=device)},
        "nlvr": [{"dense0": init_linear(generator, d, d, device=device),
                  "dense1": init_linear(generator, d, d, device=device),
                  "merge": init_linear(generator, 2 * d, d, device=device)}
                 for _ in range(med_cfg.num_layers)],
    }


def _layer_forward(layer, twin, x, self_bias, images, fuse: bool, cfg: MedConfig, dtype=None):
    """One text-encoder layer over the two image memories `images`."""
    nh, eps = cfg.num_heads, cfg.layer_norm_eps
    sa = layer["self_attn"]
    q = split_heads(linear(sa["query"], x, dtype=dtype), nh)
    k = split_heads(linear(sa["key"], x, dtype=dtype), nh)
    v = split_heads(linear(sa["value"], x, dtype=dtype), nh)
    ctx = merge_heads(dot_product_attention(q, k, v, bias=self_bias))
    x = layer_norm(sa["norm"], linear(sa["out"], ctx, dtype=dtype) + x, eps)

    # the all-ones image mask is a zero bias, which adds nothing: none
    ca = layer["cross_attn"]
    qc = split_heads(linear(ca["query"], x, dtype=dtype), nh)
    outs = []
    for img in images:
        kc = split_heads(linear(ca["key"], img, dtype=dtype), nh)
        vc = split_heads(linear(ca["value"], img, dtype=dtype), nh)
        outs.append(merge_heads(dot_product_attention(qc, kc, vc)))
    h0 = linear(twin["dense0"], outs[0], dtype=dtype)
    h1 = linear(twin["dense1"], outs[1], dtype=dtype)
    h = linear(twin["merge"], torch.cat([h0, h1], dim=-1), dtype=dtype) if fuse else (h0 + h1) / 2
    x = layer_norm(ca["norm"], h + x, eps)

    h = gelu(linear(layer["mlp"]["fc1"], x, dtype=dtype))
    h = linear(layer["mlp"]["fc2"], h, dtype=dtype)
    return layer_norm(layer["mlp_norm"], h + x, eps)


def nlvr_forward(params, image0, image1, text_ids, text_mask, vit_cfg: ViTConfig,
                 med_cfg: MedConfig, fusion_layer: int = 6, dtype=None):
    """(B, 2) fp32 logits for the two-image entailment task: both images
    through the ViT in one batch of 2B, then the text encoder over both."""
    B = image0.shape[0]
    embeds = vit_forward(params["visual_encoder"], torch.cat([image0, image1], dim=0),
                         vit_cfg, dtype=dtype)
    images = (embeds[:B], embeds[B:])
    x = M.med_embeddings(params["text_encoder"], text_ids, med_cfg, dtype=dtype)
    self_bias = M.extended_attention_mask(text_mask, is_decoder=False)
    for i, (layer, twin) in enumerate(zip(params["text_encoder"]["layers"], params["nlvr"])):
        x = _layer_forward(layer, twin, x, self_bias, images, i >= fusion_layer, med_cfg, dtype)
    h = torch.relu(linear(params["cls_head"]["fc1"], x[:, 0, :], dtype=dtype))
    return linear(params["cls_head"]["fc2"], h, dtype=dtype).float()


def nlvr_loss(logits, targets):
    """Mean cross entropy of (B, 2) logits against (B,) class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[:, None].long()).mean()
