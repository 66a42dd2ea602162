"""MED: BERT encoder/decoder with cross-attention ("Mixture of Encoder-Decoder").

Counterpart of ``vidil_tpu/models/med.py``: BERT-base with optional
cross-attention to the vision encoder and a tied causal-LM head, post-LN,
absolute positions. ``params["layers"]`` is a list of per-layer dicts.

Modes: ``mode='text'`` (bidirectional self-attention), ``mode='multimodal'``
(+ cross-attention over encoder states), ``is_decoder=True`` (causal).
Generation uses a preallocated self-attention cache, heads folded into the
feature axis: ``(layers, B, max_len, H*Dh)`` (or one ``(B, max_len, H*Dh)``
tensor per layer, ``unrolled``), updated in place per step, optionally read
through an ancestry matrix instead of being permuted on beam reorders
(``lazy_reorder``); the cross-attention K/V are projected once per
generation.

``self_fold`` is accepted and runs unfolded, which is the fold's exact
result (see `med_forward`).

Tensor parallelism (`med_forward` with a `parallel/mesh.py:Grid` whose
model axis is > 1, the parameters sharded by
`parallel/sharding.py:shard_params`): the self-attention, the
cross-attention and the FFN run on this rank's heads and hidden columns,
Megatron's pattern (the inputs of the query/key/value and fc1 projections
through `copy_to_model`, out and fc2 row-parallel, `layers.row_linear`).
That is the training forward; the decode (prefill and steps) is unsharded.
"""

from __future__ import annotations

import math

import torch

from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models.layers import (
    ACT2FN,
    dot_product_attention,
    embedding_lookup,
    grouped_softmax_attention,
    init_embedding,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    mask_to_bias,
    matmul_f32,
    merge_heads,
    mlp_auto,
    remat,
    row_linear,
    split_heads,
    tp_mlp,
)
from vidil_tpu_torch.ops import decode_attention
from vidil_tpu_torch.ops.flash_attention import attention_auto

NEG_INF = -10000.0  # additive-mask value of the reference MED


# ---------------------------------------------------------------------------
# init (the JAX package's distributions; models/layers.py)
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, d: int, kv_dim: int, device=None):
    """One attention sub-block: query, key and value (keys and values read
    `kv_dim`-wide states), out, and its post-LN."""
    device = generator.device if device is None else device
    return {"query": init_linear(generator, d, d, device=device),
            "key": init_linear(generator, kv_dim, d, device=device),
            "value": init_linear(generator, kv_dim, d, device=device),
            "out": init_linear(generator, d, d, device=device),
            "norm": init_layer_norm(d, device)}


def init_med_layer(generator: torch.Generator, cfg: MedConfig, device=None):
    device = generator.device if device is None else device
    d = cfg.hidden_size
    layer = {
        "self_attn": init_attention(generator, d, d, device),
        "mlp": {"fc1": init_linear(generator, d, cfg.intermediate_size, device=device),
                "fc2": init_linear(generator, cfg.intermediate_size, d, device=device)},
        "mlp_norm": init_layer_norm(d, device),
    }
    if cfg.add_cross_attention:
        layer["cross_attn"] = init_attention(generator, d, cfg.encoder_width, device)
    return layer


def init_med(generator: torch.Generator, cfg: MedConfig, with_lm_head: bool = False,
             with_pooler: bool = False, device=None):
    """Random MED parameters: word and position embeddings and linears
    truncated normal (std 0.02), LayerNorms ones and zeros. The LM head
    (`with_lm_head`) is the transform (dense, LayerNorm) and a zero output
    bias; its decoder weight is the word embedding (tied)."""
    device = generator.device if device is None else device
    d = cfg.hidden_size
    params = {
        "embeddings": {
            "word": init_embedding(generator, cfg.vocab_size, d, device=device),
            "position": init_embedding(generator, cfg.max_position_embeddings, d, device=device),
            "norm": init_layer_norm(d, device),
        },
        "layers": [init_med_layer(generator, cfg, device) for _ in range(cfg.num_layers)],
    }
    if with_pooler:
        params["pooler"] = init_linear(generator, d, d, device=device)
    if with_lm_head:
        params["cls"] = init_lm_head(generator, cfg, device)
    return params


def init_lm_head(generator: torch.Generator, cfg: MedConfig, device=None):
    """The LM head's own parameters: the transform (dense, LayerNorm) and a
    zero output bias (its decoder weight is the tied word embedding)."""
    device = generator.device if device is None else device
    d = cfg.hidden_size
    return {"transform": {"dense": init_linear(generator, d, d, device=device),
                          "norm": init_layer_norm(d, device)},
            "bias": torch.zeros(cfg.vocab_size, device=device)}


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


def med_pooler(params, hidden, dtype=None):
    """Tanh pooler over the first token."""
    return torch.tanh(linear(params["pooler"], hidden[:, 0], dtype=dtype))


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

def _grouped_attention(q, k, v, bias, group_size: int, grid=None):
    """Attention where ``group_size`` query rows share one K/V batch row.

    q: (B*G, H, L, Dh), k/v: (B, H, Lk, Dh). With no bias the group folds
    into the query axis, (B, H, G*L, Dh), and goes to `attention_auto` as
    a strided view (no copy when q is a split_heads view of a projection):
    the flash kernel where the reference's gate sends the fold (on `grid`'s
    global shape, `attention_auto`)."""
    Bn, H, L, Dh = q.shape
    B = Bn // group_size
    if bias is None:
        qf = (q.reshape(B, group_size, H, L, Dh)
              .transpose(1, 2).reshape(B, H, group_size * L, Dh))
        ctx = attention_auto(qf, k, v, grid=grid.gate if grid is not None else (1, 1))
        return (ctx.reshape(B, H, group_size, L, Dh)
                .transpose(1, 2).reshape(Bn, H, L, Dh))
    return grouped_softmax_attention(q, k, v, bias, group_size)


def _attn_block(p, x, kv_states, bias, num_heads: int, eps: float, dtype=None,
                group_size: int = 1, grid=None):
    """Project q from x, k/v from kv_states; attend; residual + LN.
    group_size > 1 (cross-attention only): x has batch B*group_size, and
    each group attends one memory row without replicating it. Under
    `grid`'s model axis: this rank's heads; x enters the projections
    through `copy_to_model` (a cross-attention's memory already has, in
    `med_forward`) and out is row-parallel."""
    tp = grid is not None and grid.tensor_parallel
    xin = x
    if tp:
        from vidil_tpu_torch.parallel.collectives import copy_to_model

        xin = copy_to_model(x, grid.model_group)
        num_heads //= grid.model
    kv_in = xin if kv_states is x else kv_states
    q = split_heads(linear(p["query"], xin, dtype=dtype), num_heads)
    k = split_heads(linear(p["key"], kv_in, dtype=dtype), num_heads)
    v = split_heads(linear(p["value"], kv_in, dtype=dtype), num_heads)
    if group_size > 1:
        ctx = merge_heads(_grouped_attention(q, k, v, bias, group_size, grid))
    else:
        ctx = merge_heads(dot_product_attention(q, k, v, bias=bias))
    if tp:
        out = row_linear(p["out"], ctx, grid.model_group, dtype=dtype)
    else:
        out = linear(p["out"], ctx, dtype=dtype)
    return layer_norm(p["norm"], out + x, eps)


def _attn_block_precomputed_kv(p, x, k, v, eps: float, dtype=None, beam_size: int = 1):
    """Cross-attention with precomputed K/V (B, H, Lk, Dh) over every key
    (no mask: the decode's callers attend the whole memory). beam_size > 1: x has batch B*beam_size
    but k/v have batch B — the beams of one item attend the same memory
    (queries fold into the row axis; K/V are not replicated). The attention
    is `decode_attention.decode_cross_attention` (kernel K6 on the card,
    which reads k and v in place)."""
    q = linear(p["query"], x, dtype=dtype)  # (B*nb, L, D)
    ctx = decode_attention.decode_cross_attention(q, k, v, beam_size)
    out = linear(p["out"], ctx, dtype=dtype)
    return layer_norm(p["norm"], out + x, eps)


def _ffn_block(layer, x, cfg: MedConfig, dtype=None, grid=None):
    act = ACT2FN[cfg.hidden_act]
    if grid is not None and grid.tensor_parallel:
        h = tp_mlp(layer["mlp"], x, grid.model_group, act=act, dtype=dtype)
    else:
        h = mlp_auto(layer["mlp"], x, act=act, dtype=dtype, use_fused=cfg.use_fused_mlp)
    return layer_norm(layer["mlp_norm"], h + x, cfg.layer_norm_eps)


def med_layer_forward(layer, x, self_bias, cfg: MedConfig, encoder_hidden_states=None,
                      cross_bias=None, dtype=None, group_size: int = 1, grid=None):
    """One MED layer: self-attn [-> cross-attn] -> FFN."""
    x = _attn_block(layer["self_attn"], x, x, self_bias, cfg.num_heads, cfg.layer_norm_eps, dtype,
                    grid=grid)
    if encoder_hidden_states is not None:
        x = _attn_block(layer["cross_attn"], x, encoder_hidden_states, cross_bias,
                        cfg.num_heads, cfg.layer_norm_eps, dtype, group_size=group_size,
                        grid=grid)
    return _ffn_block(layer, x, cfg, dtype, grid)


# ---------------------------------------------------------------------------
# full-sequence forward (encoder modes + decoder training)
# ---------------------------------------------------------------------------

def med_forward(params, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, *, cfg: MedConfig, mode: str = "multimodal",
                is_decoder: bool = False, inputs_embeds=None, dtype=None,
                group_size: int = 1, self_fold: int = 1, grid=None):
    """BertModel.forward equivalent. Returns the last hidden state (B, L, D).

    group_size > 1: input_ids has batch B*group_size while
    encoder_hidden_states has batch B (grouped ITM scoring).

    self_fold is accepted and ignored. The JAX package folds F consecutive
    text rows into one block-diagonal self-attention sequence to feed its
    matrix unit larger tiles; in fp32 the out-of-block weights underflow to
    0.0, so the fold's result is the unfolded run's bit for bit. Everything
    else in a layer is row-wise, and the grouped cross-attention hands
    `attention_auto` the same (B, H, G*L, Dh) query axis either way, so the
    port runs unfolded and gets the fold's exact result.

    grid: the train steps' (data, model) grid (`parallel/mesh.py:Grid`):
    the attention gate reads the step's global shape, and a model axis runs
    every layer tensor-parallel on sharded parameters (module docstring).
    The remat (``cfg.remat``) recomputes each layer, or all but its GEMM
    outputs under ``remat_policy: dots``."""
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
        # grouped cross-attention can take the flash kernel
        cross_bias = (None if encoder_attention_mask is None
                      else invert_attention_mask(encoder_attention_mask))
        enc = encoder_hidden_states if dtype is None else encoder_hidden_states.to(dtype)
        if grid is not None and grid.tensor_parallel:
            from vidil_tpu_torch.parallel.collectives import copy_to_model

            # one copy for every layer's key/value columns: their partial
            # input gradients are summed here, then over the model group once
            enc = copy_to_model(enc, grid.model_group)
    else:
        cross_bias = None
        enc = None

    def run(layer, x):
        return med_layer_forward(layer, x, self_bias, cfg, encoder_hidden_states=enc,
                                 cross_bias=cross_bias, dtype=dtype, group_size=group_size,
                                 grid=grid)

    # remat: recompute each layer in the backward instead of keeping its
    # activations (the trainers turn it on)
    run = remat(run, cfg.remat, cfg.remat_policy)
    for layer in params["layers"]:
        x = run(layer, x)
    return x


def med_lm_loss(logits, labels, label_smoothing: float = 0.1, reduction: str = "mean",
                grid=None):
    """Shifted next-token cross entropy with label smoothing, -100 = ignore
    (torch CrossEntropyLoss(label_smoothing=eps)):
    loss = (1 - eps) * nll + eps * mean_j(-log p_j).

    reduction "mean": over the valid tokens; "none": per-sample sums.
    grid (with "mean"; `parallel/mesh.py:Grid`): under its data axis the
    rows are this rank's of a global batch; the token sum is divided by
    the global batch's valid count (summed over the data group), so the
    data ranks' losses add up to the global mean and not to a mean of
    per-rank means."""
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
        count = valid.sum()
        if grid is not None and grid.data_parallel:
            from vidil_tpu_torch.parallel.collectives import psum

            count = psum(count, grid.data_group)
        return per_tok.sum() / count.clamp_min(1)
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
                    *, device=None, unrolled: bool = False, lazy_reorder: bool = False):
    """Fixed-shape self-attention KV cache, heads folded into the feature
    axis: {'k', 'v'} each (layers, batch, max_len, H*Dh).

    unrolled=True keeps one (batch, max_len, H*Dh) tensor per layer (lists)
    instead of one stacked tensor; a beam reorder then gathers each layer's
    tensor. lazy_reorder=True adds 'anc', an int32 (batch, max_len)
    ancestry matrix: a beam reorder gathers only it, and the decode step
    reads slot t of row r from row anc[r, t] (the value a physical reorder
    would have moved there, so the tokens are the same)."""
    shape = (batch, max_len, cfg.hidden_size)
    if unrolled:
        cache = {name: [torch.zeros(shape, dtype=dtype, device=device)
                        for _ in range(cfg.num_layers)] for name in ("k", "v")}
    else:
        cache = {name: torch.zeros((cfg.num_layers,) + shape, dtype=dtype, device=device)
                 for name in ("k", "v")}
    if lazy_reorder:
        rows = torch.arange(batch, dtype=torch.int32, device=device)
        cache["anc"] = rows[:, None].repeat(1, max_len)
    return cache


def reorder_cache(cache, idx):
    """The beam reorder: rows of the cache gathered by the flat beam index
    `idx`; with an ancestry matrix, only it is gathered."""
    if "anc" in cache:
        return dict(cache, anc=cache["anc"][idx])
    if isinstance(cache["k"], list):
        return {name: [x[idx] for x in c] for name, c in cache.items()}
    return {name: c[:, idx] for name, c in cache.items()}


def _fold_heads(x):
    """(B, H, L, Dh) -> (B, L, H*Dh) (cache storage layout)."""
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)


def med_decode_prefill(params, input_ids, cache, cross_k, cross_v, cfg: MedConfig,
                       dtype=None, beam_size: int = 1):
    """Run the prompt through the decoder, writing cache slots [0, Lp) of
    every layer in place. Returns (hidden (B, Lp, D), cache). The prompt is
    unpadded and of one length across the batch."""
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
                                           cfg.layer_norm_eps, dtype, beam_size=beam_size)
        x = _ffn_block(layer, x, cfg, dtype=dtype)
        # cache["k"][i] is layer i's (B, max_len, D) tensor in both layouts
        # (a view of the stacked one), so the writes land in the cache
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, :Lp] = _fold_heads(k).to(kc.dtype)
        vc[:, :Lp] = _fold_heads(v).to(vc.dtype)
    return x, cache


def med_decode_step(params, token_ids, step_index: int, cache, cross_k, cross_v,
                    cfg: MedConfig, dtype=None, beam_size: int = 1):
    """Decode one token for the whole batch, writing this step's K/V into
    the cache in place.

    token_ids: (B,); step_index: absolute position of this token (cache
    slots [0, step_index) hold the history). With an ancestry matrix
    ('anc'), this step's slot is stamped with the row's own index and every
    read gathers through it. Returns (logits (B, V) fp32, cache)."""
    B = token_ids.shape[0]
    max_len = cache["k"][0].shape[-2]
    H = cfg.num_heads
    Dh = cfg.hidden_size // H
    x = med_embeddings(params, token_ids[:, None], cfg, position_offset=step_index, dtype=dtype)
    pos = torch.arange(max_len, device=token_ids.device)
    step_bias = torch.where(pos <= step_index, 0.0, NEG_INF)[None, None, None, :]
    scale = 1.0 / math.sqrt(Dh)
    anc = cache.get("anc")
    if anc is not None:
        anc[:, step_index] = torch.arange(B, dtype=anc.dtype, device=anc.device)
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        q = split_heads(linear(sa["query"], x, dtype=dtype), H)  # (B, H, 1, Dh)
        k_new = linear(sa["key"], x, dtype=dtype)  # (B, 1, H*Dh)
        v_new = linear(sa["value"], x, dtype=dtype)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, step_index] = k_new[:, 0].to(kc.dtype)
        vc[:, step_index] = v_new[:, 0].to(vc.dtype)
        if anc is not None:
            kc, vc = kc[anc, pos[None, :]], vc[anc, pos[None, :]]
        # heads re-split view-only: (B, H, L, Dh)
        k4 = kc.reshape(B, max_len, H, Dh).transpose(1, 2).to(q.dtype)
        v4 = vc.reshape(B, max_len, H, Dh).transpose(1, 2).to(q.dtype)
        logits = matmul_f32(q, k4.transpose(-1, -2)) * scale
        probs = torch.softmax(logits + step_bias, dim=-1)
        ctx = merge_heads(torch.matmul(probs.to(v4.dtype), v4))
        h = linear(sa["out"], ctx, dtype=dtype)
        x = layer_norm(sa["norm"], h + x, cfg.layer_norm_eps)
        if cross_k is not None:
            x = _attn_block_precomputed_kv(layer["cross_attn"], x, cross_k[i], cross_v[i],
                                           cfg.layer_norm_eps, dtype, beam_size=beam_size)
        x = _ffn_block(layer, x, cfg, dtype=dtype)
    logits = med_lm_logits(params, x[:, 0, :], cfg, dtype=dtype)
    return logits.float(), cache
