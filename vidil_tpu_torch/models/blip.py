"""BLIP assemblies: caption decoder and ITM scorer, from the ViT and MED cores.

Counterpart of ``vidil_tpu/models/blip.py``. Strings stay on the host
(tokenizer); everything else runs on the tensors' device.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import linear
from vidil_tpu_torch.models.vit import vit_forward
from vidil_tpu_torch.ops.generation import GenerationConfig, beam_search


def encode_images(params, images, vit_cfg: ViTConfig, dtype=None):
    """images (B, H, W, C) -> (B, P+1, D)."""
    return vit_forward(params["visual_encoder"], images, vit_cfg, dtype=dtype)


def encode_video_frames(params, video, vit_cfg: ViTConfig, dtype=None):
    """Concat-frame late fusion: video (B, N, H, W, C) -> (B, N*(P+1), D),
    all frames through the ViT in one batch, then flattened along the
    token axis."""
    B, N = video.shape[:2]
    embeds = vit_forward(params["visual_encoder"], video.reshape((B * N,) + video.shape[2:]),
                         vit_cfg, dtype=dtype)
    return embeds.reshape(B, N * embeds.shape[1], embeds.shape[2])


def blip_caption_loss(params, image_embeds, input_ids, attention_mask, med_cfg: MedConfig,
                      prompt_length: int, dtype=None):
    """LM loss with prompt and pad masking: input_ids start with the [DEC]
    bos token; the first prompt_length positions and the pads are -100."""
    labels = torch.where(attention_mask == 1, input_ids, torch.full_like(input_ids, -100))
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    labels = torch.where(pos[None, :] < prompt_length, torch.full_like(labels, -100), labels)
    hidden = M.med_forward(
        params["text_decoder"], input_ids, attention_mask,
        encoder_hidden_states=image_embeds, cfg=med_cfg,
        mode="multimodal", is_decoder=True, dtype=dtype,
    )
    logits = M.med_lm_logits(params["text_decoder"], hidden, med_cfg, dtype=dtype)
    return M.med_lm_loss(logits, labels, label_smoothing=med_cfg.label_smoothing)


def make_decoder_closures(params, cross_k, cross_v, cross_bias, med_cfg: MedConfig,
                          dtype=None, beam_size: int = 1):
    dec = params["text_decoder"]

    def prefill_fn(ids, cache):
        h, cache = M.med_decode_prefill(dec, ids, cache, cross_k, cross_v, cross_bias,
                                        med_cfg, dtype=dtype, beam_size=beam_size)
        return M.med_lm_logits(dec, h[:, -1], med_cfg, dtype=dtype).float(), cache

    def step_fn(tokens, idx, cache):
        return M.med_decode_step(dec, tokens, idx, cache, cross_k, cross_v, cross_bias,
                                 med_cfg, dtype=dtype, beam_size=beam_size)

    def reorder_fn(cache, idx):
        return {name: c[:, idx] for name, c in cache.items()}

    return prefill_fn, step_fn, reorder_fn


def blip_generate_ids(params, image_embeds, prompt_ids, med_cfg: MedConfig,
                      gen: GenerationConfig, sample: bool = False, dtype=None,
                      beam_group_kv: bool = False,
                      cross_kv_int8: bool | str = False, decode_layer_unroll: bool = False,
                      decode_lazy_reorder: bool = False):
    """Beam-search token ids from encoded images.

    image_embeds: (B, Lk, D), not beam-expanded; prompt_ids: (B, Lp)
    starting with [DEC], without the trailing [SEP]. beam_group_kv=True
    keeps the cross K/V at batch B (the beams of one item share it);
    False replicates it per beam (the reference's repeat_interleave).
    Token outputs are the same either way.
    """
    if sample:
        raise NotImplementedError("vidil_tpu_torch: nucleus sampling is not ported yet")
    if cross_kv_int8 or decode_layer_unroll or decode_lazy_reorder:
        raise NotImplementedError(
            "vidil_tpu_torch: cross_kv_int8 / decode_layer_unroll / decode_lazy_reorder "
            "are not ported yet")
    B = image_embeds.shape[0]
    nb = gen.num_beams
    beam_size = nb if beam_group_kv else 1
    kv_src = image_embeds if beam_group_kv else image_embeds.repeat_interleave(nb, dim=0)
    cross_k, cross_v = M.precompute_cross_kv(params["text_decoder"], kv_src, med_cfg, dtype=dtype)
    # the all-ones memory mask gives a bias of zeros, which adds nothing
    # to the logits (x + 0 == x): pass none
    cache = M.init_self_cache(med_cfg, B * nb, gen.max_length,
                              dtype=dtype or torch.float32,
                              device=image_embeds.device)
    prefill_fn, step_fn, reorder_fn = make_decoder_closures(
        params, cross_k, cross_v, None, med_cfg, dtype=dtype, beam_size=beam_size)
    seqs, _ = beam_search(prompt_ids, cache, prefill_fn, step_fn, reorder_fn, gen)
    return seqs


def decode_captions(tokenizer, sequences, prompt: str) -> list[str]:
    """Token ids (host array) -> caption strings, the text prompt stripped."""
    out = []
    for row in sequences:
        text = tokenizer.decode(row, skip_special_tokens=True)
        out.append(text[len(prompt):])
    return out


def blip_itm_scores(params, image_embeds, text_ids, text_mask, med_cfg: MedConfig,
                    dtype=None, group_size: int = 1, self_fold: int = 1):
    """ITM head logits (N[*G], 2) fp32 over [CLS] of the multimodal encoding.

    image_embeds (N, Lk, D) pair 1:1 with text rows (N, L), or with
    group_size=G with (N*G, L) text rows: each group of G consecutive texts
    scores against one image memory without replicating it."""
    hidden = M.med_forward(
        params["text_encoder"], text_ids, text_mask,
        encoder_hidden_states=image_embeds, cfg=med_cfg, mode="multimodal",
        dtype=dtype, group_size=group_size, self_fold=self_fold,
    )
    return linear(params["itm_head"], hidden[:, 0, :], dtype=dtype).float()


# ---------------------------------------------------------------------------
# parameter shapes (JAX-package layout: stacked layer axis, (in, out)
# kernels) for synthetic weights; see utils/synth.py
# ---------------------------------------------------------------------------

def _lin(i, o):
    return {"kernel": (i, o), "bias": (o,)}


def _ln(d):
    return {"scale": (d,), "bias": (d,)}


def _stacked(n, tree):
    if isinstance(tree, dict):
        return {k: _stacked(n, v) for k, v in tree.items()}
    return (n,) + tuple(tree)


def vit_shapes(cfg: ViTConfig) -> dict:
    d = cfg.hidden_size
    h = int(d * cfg.mlp_ratio)
    block = {"norm1": _ln(d), "attn": {"qkv": _lin(d, 3 * d), "proj": _lin(d, d)},
             "norm2": _ln(d), "mlp": {"fc1": _lin(d, h), "fc2": _lin(h, d)}}
    return {
        "patch_embed": _lin(cfg.patch_size * cfg.patch_size * cfg.in_channels, d),
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.seq_len, d),
        "blocks": _stacked(cfg.num_layers, block),
        "norm": _ln(d),
    }


def med_shapes(cfg: MedConfig, with_lm_head: bool = False) -> dict:
    d = cfg.hidden_size
    layer = {
        "self_attn": {"query": _lin(d, d), "key": _lin(d, d), "value": _lin(d, d),
                      "out": _lin(d, d), "norm": _ln(d)},
        "mlp": {"fc1": _lin(d, cfg.intermediate_size), "fc2": _lin(cfg.intermediate_size, d)},
        "mlp_norm": _ln(d),
    }
    if cfg.add_cross_attention:
        layer["cross_attn"] = {"query": _lin(d, d), "key": _lin(cfg.encoder_width, d),
                               "value": _lin(cfg.encoder_width, d), "out": _lin(d, d),
                               "norm": _ln(d)}
    tree = {
        "embeddings": {"word": {"embedding": (cfg.vocab_size, d)},
                       "position": {"embedding": (cfg.max_position_embeddings, d)},
                       "norm": _ln(d)},
        "layers": _stacked(cfg.num_layers, layer),
    }
    if with_lm_head:
        tree["cls"] = {"transform": {"dense": _lin(d, d), "norm": _ln(d)},
                       "bias": (cfg.vocab_size,)}
    return tree


def blip_decoder_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    return {"visual_encoder": vit_shapes(vit_cfg),
            "text_decoder": med_shapes(med_cfg, with_lm_head=True)}


def blip_itm_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig, embed_dim: int = 256) -> dict:
    return {"visual_encoder": vit_shapes(vit_cfg),
            "text_encoder": med_shapes(med_cfg),
            "vision_proj": _lin(vit_cfg.hidden_size, embed_dim),
            "text_proj": _lin(med_cfg.hidden_size, embed_dim),
            "itm_head": _lin(med_cfg.hidden_size, 2)}


def blip_retrieval_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig, embed_dim: int = 256) -> dict:
    """The retrieval model: the ITM tree and the contrastive temperature
    (a 0-d leaf; set it to 0.07 after a synthetic fill, as
    `init_retrieval_params` does)."""
    return {**blip_itm_shapes(vit_cfg, med_cfg, embed_dim), "temp": ()}


def blip_pretrain_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig, embed_dim: int = 256) -> dict:
    """The pretraining model: the retrieval tree plus the decoder's own
    attention blocks and LM head (its other weights are the text
    encoder's, `blip_pretrain.tied_decoder_params`)."""
    dec = med_shapes(med_cfg, with_lm_head=True)
    return {**blip_retrieval_shapes(vit_cfg, med_cfg, embed_dim),
            "decoder_attn": {"self_attn": dec["layers"]["self_attn"],
                             "cross_attn": dec["layers"]["cross_attn"]},
            "decoder_cls": dec["cls"]}
