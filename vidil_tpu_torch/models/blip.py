"""BLIP assemblies: caption decoder and ITM scorer, from the ViT and MED cores.

Counterpart of ``vidil_tpu/models/blip.py``. Strings stay on the host
(tokenizer); everything else runs on the tensors' device.
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import init_linear, linear
from vidil_tpu_torch.models.vit import init_vit, vit_forward
from vidil_tpu_torch.ops.decode_graph import DecodeGraphs, eager_piece, storage_key
from vidil_tpu_torch.ops.generation import GenerationConfig, beam_search, nucleus_sample
from vidil_tpu_torch.utils.profiling import annotate


# ---------------------------------------------------------------------------
# init (the JAX package's distributions; models/layers.py)
# ---------------------------------------------------------------------------

def init_blip_decoder(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                      device=None):
    return {"visual_encoder": init_vit(generator, vit_cfg, device),
            "text_decoder": M.init_med(generator, med_cfg, with_lm_head=True, device=device)}


def init_blip_itm(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                  embed_dim: int = 256, device=None):
    return {"visual_encoder": init_vit(generator, vit_cfg, device),
            "text_encoder": M.init_med(generator, med_cfg, device=device),
            "vision_proj": init_linear(generator, vit_cfg.hidden_size, embed_dim, device=device),
            "text_proj": init_linear(generator, med_cfg.hidden_size, embed_dim, device=device),
            "itm_head": init_linear(generator, med_cfg.hidden_size, 2, device=device)}


def init_blip_base(generator: torch.Generator, vit_cfg: ViTConfig, med_cfg: MedConfig,
                   device=None):
    """BLIP_Base, the feature extractor (`blip_base_features`)."""
    return {"visual_encoder": init_vit(generator, vit_cfg, device),
            "text_encoder": M.init_med(generator, med_cfg, device=device)}


def encode_images(params, images, vit_cfg: ViTConfig, dtype=None, grid=None):
    """images (B, H, W, C) -> (B, P+1, D); `grid`: `vit_forward`'s."""
    return vit_forward(params["visual_encoder"], images, vit_cfg, dtype=dtype, grid=grid)


def encode_video_frames(params, video, vit_cfg: ViTConfig, dtype=None, grid=None):
    """Concat-frame late fusion: video (B, N, H, W, C) -> (B, N*(P+1), D),
    all frames through the ViT in one batch, then flattened along the
    token axis. grid: the train steps' (`vit_forward`)."""
    B, N = video.shape[:2]
    embeds = vit_forward(params["visual_encoder"], video.reshape((B * N,) + video.shape[2:]),
                         vit_cfg, dtype=dtype, grid=grid)
    return embeds.reshape(B, N * embeds.shape[1], embeds.shape[2])


def blip_caption_loss(params, image_embeds, input_ids, attention_mask, med_cfg: MedConfig,
                      prompt_length: int, dtype=None, grid=None):
    """LM loss with prompt and pad masking: input_ids start with the [DEC]
    bos token; the first prompt_length positions and the pads are -100.
    grid: the train step's (`parallel/mesh.py:Grid`): this rank's share of
    the global batch's mean (`med_lm_loss`), the decoder on its heads."""
    labels = torch.where(attention_mask == 1, input_ids, torch.full_like(input_ids, -100))
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)
    labels = torch.where(pos[None, :] < prompt_length, torch.full_like(labels, -100), labels)
    hidden = M.med_forward(
        params["text_decoder"], input_ids, attention_mask,
        encoder_hidden_states=image_embeds, cfg=med_cfg,
        mode="multimodal", is_decoder=True, dtype=dtype, grid=grid,
    )
    logits = M.med_lm_logits(params["text_decoder"], hidden, med_cfg, dtype=dtype)
    return M.med_lm_loss(logits, labels, label_smoothing=med_cfg.label_smoothing, grid=grid)


def make_decoder_closures(params, cross_k, cross_v, med_cfg: MedConfig, dtype=None,
                          beam_size: int = 1):
    dec = params["text_decoder"]

    def prefill_fn(ids, cache):
        h, cache = M.med_decode_prefill(dec, ids, cache, cross_k, cross_v, med_cfg,
                                        dtype=dtype, beam_size=beam_size)
        return M.med_lm_logits(dec, h[:, -1], med_cfg, dtype=dtype).float(), cache

    def step_fn(tokens, idx, cache):
        return M.med_decode_step(dec, tokens, idx, cache, cross_k, cross_v, med_cfg,
                                 dtype=dtype, beam_size=beam_size)

    return prefill_fn, step_fn, M.reorder_cache


def _decoder_memory(params, image_embeds, med_cfg: MedConfig, rows: int, max_length: int,
                    repeat: int, dtype, cache_dtype, unrolled: bool, lazy_reorder: bool):
    """A decode's cross K/V over image_embeds (repeated `repeat` times along
    the batch first) and its empty self cache of `rows` rows. The decode
    takes no memory bias: the all-ones memory mask gives a bias of zeros,
    which adds nothing to the logits (x + 0 == x)."""
    kv_src = image_embeds if repeat == 1 else image_embeds.repeat_interleave(repeat, dim=0)
    cross_k, cross_v = M.precompute_cross_kv(params["text_decoder"], kv_src, med_cfg, dtype=dtype)
    cache = M.init_self_cache(med_cfg, rows, max_length,
                              dtype=cache_dtype or dtype or torch.float32,
                              device=image_embeds.device, unrolled=unrolled,
                              lazy_reorder=lazy_reorder)
    return cross_k, cross_v, cache


def blip_generate_ids(params, image_embeds, prompt_ids, med_cfg: MedConfig,
                      gen: GenerationConfig, sample: bool = False, generator=None,
                      noise=None, dtype=None, cache_dtype=None, beam_group_kv: bool = False,
                      decode_layer_unroll: bool = False, decode_lazy_reorder: bool = False,
                      graphs: DecodeGraphs | None = None):
    """Token ids from encoded images, by beam search (`blip_beam_search`)
    or (``sample``) by nucleus sampling from `generator` (or the given
    per-step `noise`, see `nucleus_sample`).

    image_embeds: (B, Lk, D), not beam-expanded; prompt_ids: (B, Lp)
    starting with [DEC], without the trailing [SEP]. beam_group_kv=True
    keeps the cross K/V at batch B (the beams of one item share it);
    False replicates it per beam (the reference's repeat_interleave).
    Token outputs are the same either way. Sampling runs one row per item
    (no beams, so neither applies). cache_dtype: the self-K/V cache's dtype
    (default `dtype`, else fp32), as the reference's.

    decode_layer_unroll and decode_lazy_reorder change the cache's layout
    and the beam reorder, not the tokens (`M.init_self_cache`); sampling
    never reorders, so it drops the lazy reorder. graphs: the caller's CUDA
    graphs of the beam decode (`blip_beam_search`); sampling runs eager."""
    if not sample:
        seqs, _ = blip_beam_search(
            params, image_embeds, prompt_ids, med_cfg, gen, dtype=dtype,
            cache_dtype=cache_dtype, beam_group_kv=beam_group_kv,
            decode_layer_unroll=decode_layer_unroll, decode_lazy_reorder=decode_lazy_reorder,
            graphs=graphs)
        return seqs
    with annotate("decode.prefill"):  # the cross K/V and the empty self cache
        cross_k, cross_v, cache = _decoder_memory(
            params, image_embeds, med_cfg, image_embeds.shape[0], gen.max_length, 1, dtype,
            cache_dtype, decode_layer_unroll, False)
    prefill_fn, step_fn, _ = make_decoder_closures(
        params, cross_k, cross_v, med_cfg, dtype=dtype, beam_size=1)
    return nucleus_sample(prompt_ids, cache, prefill_fn, step_fn, gen,
                          generator=generator, noise=noise)


def blip_beam_search(params, image_embeds, prompt_ids, med_cfg: MedConfig,
                     gen: GenerationConfig, dtype=None, cache_dtype=None,
                     beam_group_kv: bool = False, decode_layer_unroll: bool = False,
                     decode_lazy_reorder: bool = False, graphs: DecodeGraphs | None = None):
    """The beam path of `blip_generate_ids` (its arguments): the sequences
    (B, max_length) int32 and the best hypotheses' scores (B,) fp32.

    With `graphs` (`ops/decode_graph.py`), a CUDA decode of
    ``gen.early_exit=False`` (no step depends on the data) runs from CUDA
    graphs once its key has been seen: the same kernels on the same
    operands, so the same tokens and scores. The key covers the shapes and
    dtypes of the inputs, the configurations, every option here and the
    decoder weights' storage."""
    nb = gen.num_beams
    beam_size = nb if beam_group_kv else 1

    def decode(image_embeds, prompt_ids, piece=eager_piece):
        with piece("decode.prefill"):  # the cross K/V and the empty self cache
            cross_k, cross_v, cache = _decoder_memory(
                params, image_embeds, med_cfg, image_embeds.shape[0] * nb, gen.max_length,
                nb // beam_size, dtype, cache_dtype, decode_layer_unroll, decode_lazy_reorder)
        prefill_fn, step_fn, reorder_fn = make_decoder_closures(
            params, cross_k, cross_v, med_cfg, dtype=dtype, beam_size=beam_size)
        return beam_search(prompt_ids, cache, prefill_fn, step_fn, reorder_fn, gen, piece=piece)

    if graphs is None or gen.early_exit:
        return decode(image_embeds, prompt_ids)
    key = (tuple(image_embeds.shape), image_embeds.dtype, image_embeds.device,
           tuple(prompt_ids.shape), prompt_ids.dtype, med_cfg, gen, dtype, cache_dtype,
           beam_group_kv, decode_layer_unroll, decode_lazy_reorder,
           storage_key(params["text_decoder"]))
    return graphs.run(key, decode, image_embeds, prompt_ids)


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


def blip_itc_features(params, image_embeds, text_ids, text_mask, med_cfg: MedConfig,
                      dtype=None):
    """Projected, unit-norm [CLS] features for contrastive similarity:
    (image_feat (N, E), text_feat (M, E))."""
    image_feat = linear(params["vision_proj"], image_embeds[:, 0, :], dtype=dtype)
    image_feat = image_feat / torch.linalg.vector_norm(image_feat, dim=-1, keepdim=True)
    text_hidden = M.med_forward(params["text_encoder"], text_ids, text_mask, cfg=med_cfg,
                                mode="text", dtype=dtype)
    text_feat = linear(params["text_proj"], text_hidden[:, 0, :], dtype=dtype)
    text_feat = text_feat / torch.linalg.vector_norm(text_feat, dim=-1, keepdim=True)
    return image_feat, text_feat


def blip_base_features(params, mode: str, vit_cfg: ViTConfig, med_cfg: MedConfig,
                       images=None, text_ids=None, text_mask=None,
                       enc_token_id: int | None = None, dtype=None):
    """BLIP_Base's feature modes: 'image', the ViT embeddings (B, P+1, D);
    'text', the text encoder's hidden states; 'multimodal', the text over
    the images' embeddings by cross-attention, with [ENC] in place of the
    first id when `enc_token_id` is given (the reference's
    ``input_ids[:, 0] = enc_token_id``)."""
    if mode not in ("image", "text", "multimodal"):
        raise ValueError(f"unknown feature mode: {mode!r}")
    if mode == "image":
        return encode_images(params, images, vit_cfg, dtype=dtype)
    if mode == "text":
        return M.med_forward(params["text_encoder"], text_ids, text_mask, cfg=med_cfg,
                             mode="text", dtype=dtype)
    image_embeds = encode_images(params, images, vit_cfg, dtype=dtype)
    if enc_token_id is not None:
        text_ids = text_ids.clone()
        text_ids[:, 0] = enc_token_id
    return M.med_forward(params["text_encoder"], text_ids, text_mask,
                         encoder_hidden_states=image_embeds, cfg=med_cfg, mode="multimodal",
                         dtype=dtype)


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


def blip_nlvr_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    """The NLVR2 model: the ViT, a MED text encoder, the classification
    head and, per layer, the twin cross-attention output denses and the
    merge of their concatenation (models/blip_nlvr.py)."""
    d = med_cfg.hidden_size
    return {"visual_encoder": vit_shapes(vit_cfg),
            "text_encoder": med_shapes(med_cfg),
            "cls_head": {"fc1": _lin(d, d), "fc2": _lin(d, 2)},
            "nlvr": _stacked(med_cfg.num_layers, {"dense0": _lin(d, d), "dense1": _lin(d, d),
                                                  "merge": _lin(2 * d, d)})}


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
