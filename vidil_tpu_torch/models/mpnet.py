"""MPNet sentence encoder (SBERT 'all-mpnet-base-v2'): the port of
``vidil_tpu/models/mpnet.py``.

The reference runs SentenceTransformer('all-mpnet-base-v2') for in-context
example selection and QA/VLEP answer mapping (reference:
generate_prompts_random_prefix_in_context_selection.py:175-179,
eval_video_qa_result.py:165-170, eval_vlep.py). This module is the MPNet
architecture (post-LN transformer with a shared bucketed relative-position
attention bias, HF MPNetModel semantics) plus SBERT mean pooling and L2
normalization, with a converter from the HF / sentence-transformers torch
state dict.

Rounding points are the JAX package's: the embedding LayerNorm before the
cast to the compute dtype, linears in that dtype, fp32 attention logits
(scale, then the position and mask bias) and softmax, probabilities cast to
v's dtype before P·V, fp32 LayerNorm statistics (eps 1e-12), exact-erf
GELU, pooling and normalization in fp32. The biased attention runs
``layers.dot_product_attention``, as the JAX package runs its plain einsum
and softmax, never the flash-attention kernel. Per-layer parameters are a
list (``layers``), as ``convert.from_jax_params`` makes of the JAX
package's stacked layers.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vidil_tpu_torch.models.convert import _lin, _ln, _np, _t, to_device
from vidil_tpu_torch.models.layers import (
    cast_linears,
    dot_product_attention,
    embedding_lookup,
    gelu,
    layer_norm,
    linear,
    mask_to_bias,
    merge_heads,
    split_heads,
)


class MPNetConfig:
    def __init__(self, vocab_size=30527, hidden_size=768, num_layers=12, num_heads=12,
                 intermediate_size=3072, max_position_embeddings=514,
                 relative_attention_num_buckets=32, layer_norm_eps=1e-12,
                 pad_token_id=1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.relative_attention_num_buckets = relative_attention_num_buckets
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id


def relative_position_bucket(relative_position, num_buckets: int = 32,
                             max_distance: int = 128):
    """HF MPNet bucketing (T5-style, bidirectional) of an integer tensor.

    The large-distance branch takes log(n / max_exact) in fp32 and
    truncates it, as the JAX package does; n is clamped to max_exact first
    so that the log stays finite (log 1 = 0) where the small branch is
    taken anyway (the JAX package's log(0) = -inf is masked the same way,
    but casting -inf to an integer is undefined in torch)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    num_buckets //= 2
    ret = ret + (n < 0).to(ret.dtype) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    n_large = torch.clamp(n, min=max_exact).to(torch.float32)
    val_if_large = max_exact + (
        torch.log(n_large / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=8)
def _buckets(seq_len: int, num_buckets: int) -> torch.Tensor:
    """(L, L) buckets of mem - ctx, on the host: there the fp32 log and
    truncation match the JAX package's integer for integer at every
    L <= 514 (tests/test_torch_mpnet.py); a device's log may round
    otherwise. Never written to by callers."""
    pos = torch.arange(seq_len)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets=num_buckets)


def compute_position_bias(rel_bias_embedding, seq_len: int, num_buckets: int = 32):
    """(1, H, L, L) additive attention bias from the shared bucket embedding
    (num_buckets, H)."""
    buckets = _buckets(seq_len, num_buckets).to(rel_bias_embedding.device)
    values = rel_bias_embedding[buckets]  # (L, L, H)
    return values.permute(2, 0, 1)[None]


def mpnet_forward(params, input_ids, attention_mask, cfg: MPNetConfig, dtype=None):
    """MPNetModel.forward -> last hidden state (B, L, D)."""
    # RoBERTa-style position ids: pad stays at pad_idx, others count from pad_idx+1
    mask = (input_ids != cfg.pad_token_id).to(torch.int64)
    position_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id

    x = embedding_lookup(params["word_embeddings"], input_ids)
    x = x + embedding_lookup(params["position_embeddings"], position_ids)
    x = layer_norm(params["emb_norm"], x, cfg.layer_norm_eps)
    if dtype is not None:
        x = x.to(dtype)

    L = input_ids.shape[1]
    pos_bias = compute_position_bias(params["relative_attention_bias"], L,
                                     cfg.relative_attention_num_buckets)
    bias = pos_bias + mask_to_bias(attention_mask[:, None, None, :])
    scale = 1.0 / math.sqrt(cfg.hidden_size // cfg.num_heads)

    for layer in params["layers"]:
        q = split_heads(linear(layer["q"], x, dtype=dtype), cfg.num_heads)
        k = split_heads(linear(layer["k"], x, dtype=dtype), cfg.num_heads)
        v = split_heads(linear(layer["v"], x, dtype=dtype), cfg.num_heads)
        ctx = merge_heads(dot_product_attention(q, k, v, bias, scale))
        h = linear(layer["o"], ctx, dtype=dtype)
        x = layer_norm(layer["attn_norm"], h + x, cfg.layer_norm_eps)
        h = linear(layer["fc1"], x, dtype=dtype)
        h = gelu(h)
        h = linear(layer["fc2"], h, dtype=dtype)
        x = layer_norm(layer["out_norm"], h + x, cfg.layer_norm_eps)
    return x


def sbert_embed(params, input_ids, attention_mask, cfg: MPNetConfig, dtype=None):
    """Sentence embedding: mean pooling over the mask + L2 normalize
    (the all-mpnet-base-v2 pooling recipe), in fp32."""
    hidden = mpnet_forward(params, input_ids, attention_mask, cfg, dtype=dtype).float()
    m = attention_mask[:, :, None].float()
    pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)


def mpnet_shapes(cfg: MPNetConfig) -> dict:
    """Parameter shapes in the JAX package's layout (stacked ``layers``),
    for ``utils.synth.synth_tree``."""
    D, F, N = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def lin(i, o):
        return {"kernel": (N, i, o), "bias": (N, o)}

    def ln():
        return {"scale": (N, D), "bias": (N, D)}

    return {
        "word_embeddings": {"embedding": (cfg.vocab_size, D)},
        "position_embeddings": {"embedding": (cfg.max_position_embeddings, D)},
        "emb_norm": {"scale": (D,), "bias": (D,)},
        "relative_attention_bias": (cfg.relative_attention_num_buckets, cfg.num_heads),
        "layers": {"q": lin(D, D), "k": lin(D, D), "v": lin(D, D), "o": lin(D, D),
                   "attn_norm": ln(), "fc1": lin(D, F), "fc2": lin(F, D), "out_norm": ln()},
    }


def convert_mpnet(sd: dict, cfg: MPNetConfig, prefix: str = "") -> dict:
    """HF MPNetModel (or sentence-transformers '0_MPNet') state dict -> port
    params."""
    layers = []
    for i in range(cfg.num_layers):
        b = f"{prefix}encoder.layer.{i}."
        layers.append({
            "q": _lin(sd, b + "attention.attn.q"), "k": _lin(sd, b + "attention.attn.k"),
            "v": _lin(sd, b + "attention.attn.v"), "o": _lin(sd, b + "attention.attn.o"),
            "attn_norm": _ln(sd, b + "attention.LayerNorm"),
            "fc1": _lin(sd, b + "intermediate.dense"), "fc2": _lin(sd, b + "output.dense"),
            "out_norm": _ln(sd, b + "output.LayerNorm"),
        })
    return {
        "word_embeddings": {"embedding": _t(_np(sd[prefix + "embeddings.word_embeddings.weight"]))},
        "position_embeddings": {
            "embedding": _t(_np(sd[prefix + "embeddings.position_embeddings.weight"]))},
        "emb_norm": _ln(sd, prefix + "embeddings.LayerNorm"),
        "relative_attention_bias": _t(_np(sd[prefix + "encoder.relative_attention_bias.weight"])),
        "layers": layers,
    }


def to_hf_state_dict(params, prefix: str = "") -> dict:
    """Port params -> an HF MPNetModel state dict (CPU tensors), the
    inverse of `convert_mpnet`: a snapshot ``make_sbert_encoder`` reads."""
    sd = {}

    def lin(name, p):
        sd[name + ".weight"] = p["kernel"].detach().cpu().t().contiguous()
        sd[name + ".bias"] = p["bias"].detach().cpu().clone()

    def ln(name, p):
        sd[name + ".weight"] = p["scale"].detach().cpu().clone()
        sd[name + ".bias"] = p["bias"].detach().cpu().clone()

    sd[prefix + "embeddings.word_embeddings.weight"] = \
        params["word_embeddings"]["embedding"].detach().cpu().clone()
    sd[prefix + "embeddings.position_embeddings.weight"] = \
        params["position_embeddings"]["embedding"].detach().cpu().clone()
    ln(prefix + "embeddings.LayerNorm", params["emb_norm"])
    sd[prefix + "encoder.relative_attention_bias.weight"] = \
        params["relative_attention_bias"].detach().cpu().clone()
    for i, layer in enumerate(params["layers"]):
        b = f"{prefix}encoder.layer.{i}."
        for name in ("q", "k", "v", "o"):
            lin(b + "attention.attn." + name, layer[name])
        ln(b + "attention.LayerNorm", layer["attn_norm"])
        lin(b + "intermediate.dense", layer["fc1"])
        lin(b + "output.dense", layer["fc2"])
        ln(b + "output.LayerNorm", layer["out_norm"])
    return sd


def make_torch_sbert_encoder(params, cfg: MPNetConfig, tokenizer, max_length: int = 128,
                             batch_size: int = 64, dtype=torch.bfloat16, device="cuda"):
    """list[str] -> (n, D) fp32 numpy, the port of
    ``make_tpu_sbert_encoder``: texts padded to `max_length` in batches of
    `batch_size`, the encoder in `dtype` on `device` (CUDA unless the
    caller asks for the CPU; CUDA on a host without it raises)."""
    from vidil_tpu_torch.pipeline.capfilt import resolve_device

    device = resolve_device(device)
    params = cast_linears(to_device(params, device), dtype)

    @torch.no_grad()
    def encode(texts):
        out = []
        for i in range(0, len(texts), batch_size):
            enc = tokenizer(texts[i : i + batch_size], padding="max_length",
                            truncation=True, max_length=max_length)
            ids = torch.from_numpy(enc.input_ids).to(device)
            mask = torch.from_numpy(enc.attention_mask).to(device)
            out.append(sbert_embed(params, ids, mask, cfg, dtype=dtype).cpu().numpy())
        return np.concatenate(out)

    return encode
