"""MED: BERT encoder/decoder with cross-attention ("Mixture of Encoder-Decoder").

Counterpart of ``vidil_tpu/models/med.py``: BERT-base with optional
cross-attention to the vision encoder and a tied causal-LM head, post-LN,
absolute positions. ``params["layers"]`` is a list of per-layer dicts.

Modes: ``mode='text'`` (bidirectional self-attention), ``mode='multimodal'``
(+ cross-attention over encoder states), ``is_decoder=True`` (causal).
Generation uses a preallocated self-attention cache, heads folded into the
feature axis: ``(layers, B, max_len, H*Dh)``, updated in place per step;
the cross-attention K/V are projected once per generation.

Not ported yet: ``self_fold`` (raises) and the int8 cross-K/V branches
(`blip_generate_ids` raises for `cross_kv_int8`).
"""

from __future__ import annotations

import math

import torch

from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models.layers import (
    ACT2FN,
    dot_product_attention,
    embedding_lookup,
    layer_norm,
    linear,
    mask_to_bias,
    matmul_f32,
    merge_heads,
    mlp_auto,
    remat,
    split_heads,
)
from vidil_tpu_torch.ops.flash_attention import attention_auto

NEG_INF = -10000.0  # additive-mask value of the reference MED


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def extended_attention_mask(attention_mask, is_decoder: bool):
    """(B, L) {0,1} -> (B, 1, Lq, L) additive self-attention bias; decoders
    AND a causal mask in."""
    B, L = attention_mask.shape
    if is_decoder:
        seq_ids = torch.arange(L, device=attention_mask.device)
        causal = (seq_ids[None, None, :] <= seq_ids[None, :, None]).float()
        mask = causal * attention_mask[:, None, :].float()
        mask = mask[:, None, :, :]
    else:
        mask = attention_mask[:, None, None, :].float()
    return mask_to_bias(mask, neg=NEG_INF)


def invert_attention_mask(encoder_attention_mask):
    """(B, Lk) {0,1} -> (B, 1, 1, Lk) additive bias for cross-attention."""
    return mask_to_bias(encoder_attention_mask[:, None, None, :], neg=NEG_INF)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def med_embeddings(params, input_ids, cfg: MedConfig, position_offset=0, dtype=None):
    """Word + absolute position embeddings, LayerNorm (fp32), then cast."""
    emb = embedding_lookup(params["embeddings"]["word"], input_ids)
    L = input_ids.shape[-1]
    positions = torch.arange(L, device=input_ids.device) + position_offset
    emb = emb + embedding_lookup(params["embeddings"]["position"], positions)
    emb = layer_norm(params["embeddings"]["norm"], emb, cfg.layer_norm_eps)
    if dtype is not None:
        emb = emb.to(dtype)
    return emb


def med_lm_logits(params, hidden, cfg: MedConfig, dtype=None):
    """LM head: transform -> tied word-embedding decoder + bias."""
    h = linear(params["cls"]["transform"]["dense"], hidden, dtype=dtype)
    h = ACT2FN[cfg.hidden_act](h)
    h = layer_norm(params["cls"]["transform"]["norm"], h, cfg.layer_norm_eps)
    weight = params["embeddings"]["word"]["embedding"]
    if dtype is not None:
        weight = weight.to(dtype)
        h = h.to(dtype)
    return torch.matmul(h, weight.t()) + params["cls"]["bias"].to(h.dtype)


# ---------------------------------------------------------------------------
# attention sub-blocks (post-LN, BERT style)
# ---------------------------------------------------------------------------

def _grouped_attention(q, k, v, bias, group_size: int):
    """Attention where ``group_size`` query rows share one K/V batch row.

    q: (B*G, H, L, Dh), k/v: (B, H, Lk, Dh). With no bias the group folds
    into the query axis, (B, H, G*L, Dh), and goes to the flash kernel as a
    strided view (no copy when q is a split_heads view of a projection)."""
    Bn, H, L, Dh = q.shape
    B = Bn // group_size
    if bias is None:
        qf = (q.reshape(B, group_size, H, L, Dh)
              .transpose(1, 2).reshape(B, H, group_size * L, Dh))
        ctx = attention_auto(qf, k, v)
        return (ctx.reshape(B, H, group_size, L, Dh)
                .transpose(1, 2).reshape(Bn, H, L, Dh))
    # bias path: beams/groups become a broadcast dim (no K/V replication)
    q5 = q.reshape(B, group_size, H, L, Dh)
    scale = 1.0 / math.sqrt(Dh)
    logits = _grouped_scores(q5, k) * scale
    logits = logits + bias[:, None].float()
    probs = torch.softmax(logits, dim=-1)
    ctx = _grouped_context(probs.to(v.dtype), v)
    return ctx.reshape(Bn, H, L, Dh)


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


def _attn_block(p, x, kv_states, bias, num_heads: int, eps: float, dtype=None,
                group_size: int = 1):
    """Project q from x, k/v from kv_states; attend; residual + LN.
    group_size > 1 (cross-attention only): x has batch B*group_size, and
    each group attends one memory row without replicating it."""
    q = split_heads(linear(p["query"], x, dtype=dtype), num_heads)
    k = split_heads(linear(p["key"], kv_states, dtype=dtype), num_heads)
    v = split_heads(linear(p["value"], kv_states, dtype=dtype), num_heads)
    if group_size > 1:
        ctx = merge_heads(_grouped_attention(q, k, v, bias, group_size))
    else:
        ctx = merge_heads(dot_product_attention(q, k, v, bias=bias))
    out = linear(p["out"], ctx, dtype=dtype)
    return layer_norm(p["norm"], out + x, eps)


def _attn_block_precomputed_kv(p, x, k, v, bias, num_heads: int, eps: float,
                               dtype=None, beam_size: int = 1):
    """Cross-attention with precomputed K/V. beam_size > 1: x has batch
    B*beam_size but k/v have batch B — the beams of one item attend the
    same memory (queries fold into the row axis; K/V are not replicated)."""
    q = split_heads(linear(p["query"], x, dtype=dtype), num_heads)  # (B*nb, H, L, Dh)
    if beam_size > 1:
        Bn, H, L, Dh = q.shape
        B = Bn // beam_size
        q5 = q.reshape(B, beam_size, H, L, Dh)
        scale = 1.0 / math.sqrt(Dh)
        logits = _grouped_scores(q5, k) * scale
        if bias is not None:
            logits = logits + bias[:, None].float()
        probs = torch.softmax(logits, dim=-1)
        ctx = _grouped_context(probs.to(v.dtype), v)
        ctx = merge_heads(ctx.reshape(Bn, H, L, Dh))
    else:
        ctx = merge_heads(dot_product_attention(q, k, v, bias=bias))
    out = linear(p["out"], ctx, dtype=dtype)
    return layer_norm(p["norm"], out + x, eps)


def _ffn_block(layer, x, cfg: MedConfig, dtype=None):
    h = mlp_auto(layer["mlp"], x, act=ACT2FN[cfg.hidden_act], dtype=dtype,
                 use_fused=cfg.use_fused_mlp)
    return layer_norm(layer["mlp_norm"], h + x, cfg.layer_norm_eps)


def med_layer_forward(layer, x, self_bias, cfg: MedConfig, encoder_hidden_states=None,
                      cross_bias=None, dtype=None, group_size: int = 1):
    """One MED layer: self-attn [-> cross-attn] -> FFN."""
    x = _attn_block(layer["self_attn"], x, x, self_bias, cfg.num_heads, cfg.layer_norm_eps, dtype)
    if encoder_hidden_states is not None:
        x = _attn_block(layer["cross_attn"], x, encoder_hidden_states, cross_bias,
                        cfg.num_heads, cfg.layer_norm_eps, dtype, group_size=group_size)
    return _ffn_block(layer, x, cfg, dtype)


# ---------------------------------------------------------------------------
# full-sequence forward (encoder modes + decoder training)
# ---------------------------------------------------------------------------

def med_forward(params, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, *, cfg: MedConfig, mode: str = "multimodal",
                is_decoder: bool = False, inputs_embeds=None, dtype=None,
                group_size: int = 1, self_fold: int = 1):
    """BertModel.forward equivalent. Returns the last hidden state (B, L, D).

    group_size > 1: input_ids has batch B*group_size while
    encoder_hidden_states has batch B (grouped ITM scoring)."""
    if self_fold > 1:
        raise NotImplementedError("vidil_tpu_torch: self_fold is not ported yet")
    if inputs_embeds is None:
        x = med_embeddings(params, input_ids, cfg, dtype=dtype)
        B, L = input_ids.shape
        device = input_ids.device
    else:
        x = inputs_embeds if dtype is None else inputs_embeds.to(dtype)
        B, L = inputs_embeds.shape[:2]
        device = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((B, L), dtype=torch.int32, device=device)
    self_bias = extended_attention_mask(attention_mask, is_decoder)

    if mode == "multimodal" and encoder_hidden_states is not None:
        # no mask = attend the whole memory: keep the bias None so the
        # grouped cross-attention takes the flash kernel
        cross_bias = (None if encoder_attention_mask is None
                      else invert_attention_mask(encoder_attention_mask))
        enc = encoder_hidden_states if dtype is None else encoder_hidden_states.to(dtype)
    else:
        cross_bias = None
        enc = None

    def run(layer, x):
        return med_layer_forward(layer, x, self_bias, cfg, encoder_hidden_states=enc,
                                 cross_bias=cross_bias, dtype=dtype, group_size=group_size)

    # remat: recompute each layer in the backward instead of keeping its
    # activations (the trainers turn it on)
    run = remat(run, cfg.remat)
    for layer in params["layers"]:
        x = run(layer, x)
    return x


def med_lm_loss(logits, labels, label_smoothing: float = 0.1, reduction: str = "mean"):
    """Shifted next-token cross entropy with label smoothing, -100 = ignore
    (torch CrossEntropyLoss(label_smoothing=eps)):
    loss = (1 - eps) * nll + eps * mean_j(-log p_j).

    reduction "mean": over the valid tokens; "none": per-sample sums."""
    logits = logits[:, :-1, :].float()
    labels = labels[:, 1:]
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    smooth = -logp.mean(dim=-1)
    per_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    per_tok = torch.where(valid, per_tok, torch.zeros_like(per_tok))
    if reduction == "mean":
        return per_tok.sum() / valid.sum().clamp_min(1)
    if reduction == "none":
        return per_tok.sum(dim=-1)
    raise ValueError(reduction)


# ---------------------------------------------------------------------------
# generation: fixed-shape KV cache
# ---------------------------------------------------------------------------

def precompute_cross_kv(params, encoder_hidden_states, cfg: MedConfig, dtype=None):
    """Project cross-attention K/V for all layers once per generation.

    Returns (k, v), each (num_layers, B, H, Lk, Dh): head-split views of
    (num_layers, B, Lk, H*Dh) buffers."""
    enc = encoder_hidden_states if dtype is None else encoder_hidden_states.to(dtype)
    ks, vs = [], []
    for layer in params["layers"]:
        ks.append(linear(layer["cross_attn"]["key"], enc, dtype=dtype))
        vs.append(linear(layer["cross_attn"]["value"], enc, dtype=dtype))
    return (split_heads(torch.stack(ks), cfg.num_heads),
            split_heads(torch.stack(vs), cfg.num_heads))


def init_self_cache(cfg: MedConfig, batch: int, max_len: int, dtype=torch.float32,
                    *, device=None):
    """Fixed-shape self-attention KV cache, heads folded into the feature
    axis: {'k', 'v'} each (layers, batch, max_len, H*Dh)."""
    shape = (cfg.num_layers, batch, max_len, cfg.hidden_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _fold_heads(x):
    """(B, H, L, Dh) -> (B, L, H*Dh) (cache storage layout)."""
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)


def med_decode_prefill(params, input_ids, cache, cross_k, cross_v, cross_bias,
                       cfg: MedConfig, dtype=None, beam_size: int = 1):
    """Run the prompt through the decoder, writing cache[:, :, :Lp] in place.
    Returns (hidden (B, Lp, D), cache). The prompt is unpadded and of one
    length across the batch."""
    B, Lp = input_ids.shape
    x = med_embeddings(params, input_ids, cfg, dtype=dtype)
    seq = torch.arange(Lp, device=input_ids.device)
    causal_bias = torch.where(seq[None, :] <= seq[:, None], 0.0, NEG_INF)[None, None]
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        q = split_heads(linear(sa["query"], x, dtype=dtype), cfg.num_heads)
        k = split_heads(linear(sa["key"], x, dtype=dtype), cfg.num_heads)
        v = split_heads(linear(sa["value"], x, dtype=dtype), cfg.num_heads)
        ctx = merge_heads(dot_product_attention(q, k, v, bias=causal_bias))
        h = linear(sa["out"], ctx, dtype=dtype)
        x = layer_norm(sa["norm"], h + x, cfg.layer_norm_eps)
        if cross_k is not None:
            x = _attn_block_precomputed_kv(layer["cross_attn"], x, cross_k[i], cross_v[i],
                                           cross_bias, cfg.num_heads, cfg.layer_norm_eps,
                                           dtype, beam_size=beam_size)
        x = _ffn_block(layer, x, cfg, dtype=dtype)
        cache["k"][i, :, :Lp] = _fold_heads(k).to(cache["k"].dtype)
        cache["v"][i, :, :Lp] = _fold_heads(v).to(cache["v"].dtype)
    return x, cache


def med_decode_step(params, token_ids, step_index: int, cache, cross_k, cross_v,
                    cross_bias, cfg: MedConfig, dtype=None, beam_size: int = 1):
    """Decode one token for the whole batch, writing this step's K/V into
    the cache in place.

    token_ids: (B,); step_index: absolute position of this token (cache
    slots [0, step_index) hold the history). Returns (logits (B, V) fp32,
    cache)."""
    B = token_ids.shape[0]
    max_len = cache["k"].shape[-2]
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    x = med_embeddings(params, token_ids[:, None], cfg, position_offset=step_index, dtype=dtype)
    pos = torch.arange(max_len, device=token_ids.device)
    step_bias = torch.where(pos <= step_index, 0.0, NEG_INF)[None, None, None, :]
    scale = 1.0 / math.sqrt(Dh)
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        q = split_heads(linear(sa["query"], x, dtype=dtype), H)  # (B, H, 1, Dh)
        k_new = linear(sa["key"], x, dtype=dtype)  # (B, 1, H*Dh)
        v_new = linear(sa["value"], x, dtype=dtype)
        cache["k"][i, :, step_index] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][i, :, step_index] = v_new[:, 0].to(cache["v"].dtype)
        # heads re-split view-only: (B, H, L, Dh)
        k4 = cache["k"][i].reshape(B, max_len, H, Dh).transpose(1, 2).to(q.dtype)
        v4 = cache["v"][i].reshape(B, max_len, H, Dh).transpose(1, 2).to(q.dtype)
        logits = matmul_f32(q, k4.transpose(-1, -2)) * scale
        probs = torch.softmax(logits + step_bias, dim=-1)
        ctx = merge_heads(torch.matmul(probs.to(v4.dtype), v4))
        h = linear(sa["out"], ctx, dtype=dtype)
        x = layer_norm(sa["norm"], h + x, cfg.layer_norm_eps)
        if cross_k is not None:
            x = _attn_block_precomputed_kv(layer["cross_attn"], x, cross_k[i], cross_v[i],
                                           cross_bias, cfg.num_heads, cfg.layer_norm_eps,
                                           dtype, beam_size=beam_size)
        x = _ffn_block(layer, x, cfg, dtype=dtype)
    logits = med_lm_logits(params, x[:, 0, :], cfg, dtype=dtype)
    return logits.float(), cache
