"""Operations and bytes of the Kimi Linear cell, from its shapes: the
whole chunk's operations for `mfu.lm`, and the least time of the window's
launches of the experts' grouped GEMM (kernel K7) for `k7_roofline.lm`.

`cfg` is the configuration's dict (config.json keys). Operations count
two a multiply-add; a chunk's are

* every prompt token through the active parameters of each layer it
  computes here: KDA's projections (q, k, v, the decay's and the output
  gate's two low-rank products, beta, the output) and convolution, MLA's
  (q, the latent, its expansion into keys and values, the output), the
  dense layer, the router and the shared expert, and of the
  `num_experts_per_token` routed experts the share held here
  (`num_experts` of `num_experts_published`: the expected number of a
  token's pairs this card computes); KDA's delta rule (the state's read
  before the write, the write and the read-out, 6 H dk dv a token) and
  MLA's causal attention (q.k over 192 and p.v over 128 dimensions, the
  tokens before it); the head at each prompt's last position;
* every decoded token the same, at the cached context's length, with the
  head.
"""

from __future__ import annotations

import flops


def _dims(cfg: dict):
    la = cfg["linear_attn_config"]
    return (cfg["hidden_size"], la["num_heads"], la["head_dim"], cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
            cfg["kv_lora_rank"])


def layer_counts(cfg: dict) -> dict:
    la = cfg["linear_attn_config"]
    dense = cfg["first_k_dense_replace"]
    return {"kda": len(la["kda_layers"]), "mla": len(la["full_attn_layers"]), "dense": dense,
            "moe": cfg["num_hidden_layers"] - dense}


def held_share(cfg: dict) -> float:
    """The share of the router's experts held here."""
    return cfg["num_experts"] / (cfg.get("num_experts_published") or cfg["num_experts"])


def token_params(cfg: dict) -> float:
    """Active weights a token multiplies through the layers here (no head)."""
    D, H, dk, Hm, dn, dr, dv, r = _dims(cfg)
    width = cfg["linear_attn_config"]["short_conv_kernel_size"]
    kda = D * 3 * H * dk + 2 * (D * dk + dk * H * dk) + D * H + H * dk * D + 3 * H * dk * width
    mla = D * Hm * (dn + dr) + D * (r + dr) + r * Hm * (dn + dv) + Hm * dv * D
    Ie = cfg["moe_intermediate_size"]
    routers = cfg.get("num_experts_published") or cfg["num_experts"]
    moe = routers * D + 3 * D * Ie * (cfg["num_experts_per_token"] * held_share(cfg) + 1)
    n = layer_counts(cfg)
    return (n["kda"] * kda + n["mla"] * mla + n["dense"] * 3 * D * cfg["intermediate_size"]
            + n["moe"] * moe)


def token_flops(cfg: dict, context: int) -> float:
    """One token's operations with `context` tokens before it (head excluded)."""
    D, H, dk, Hm, dn, dr, dv, r = _dims(cfg)
    n = layer_counts(cfg)
    attn = 2.0 * (context + 1) * Hm * (dn + dr + dv)
    rule = 6.0 * H * dk * dk
    return 2.0 * token_params(cfg) + n["mla"] * attn + n["kda"] * rule


def chunk_flops(cfg: dict, lengths, new_tokens: int) -> float:
    """A chunk's operations: prompts of `lengths` tokens, then `new_tokens`
    greedy tokens each (the first from the prefill's logits)."""
    head = 2.0 * cfg["vocab_size"] * cfg["hidden_size"]
    slope = token_flops(cfg, 1) - token_flops(cfg, 0)
    total = 0.0
    for L in lengths:
        total += L * token_flops(cfg, 0) + slope * L * (L - 1) / 2.0 + head
        for s in range(1, new_tokens):
            total += token_flops(cfg, L + s - 1) + head
    return total


def k7_bound_s(cfg: dict, prefill_rows: int, decode_launches: int, decode_rows: float,
               decode_experts: int) -> float:
    """The least time of a window's K7 launches. The prefill's, bound by
    their operations: `prefill_rows` rows that held experts took, each
    through the up launch (N = 2 x moe_intermediate_size interleaved gate
    and up rows, K = hidden) and the down launch (N = hidden, K =
    moe_intermediate_size). The decode's, bound by their bytes:
    `decode_launches` launches of `decode_rows` rows each, their rows in
    and out, and `decode_experts` expert weights read in all, half of them
    by up launches (2 Ie D weights) and half by down launches (D Ie)."""
    D, Ie = cfg["hidden_size"], cfg["moe_intermediate_size"]
    ops = 2.0 * prefill_rows * (2 * Ie * D + D * Ie)
    io = decode_launches * 2.0 * decode_rows * (D + Ie) \
        + decode_experts / 2.0 * 2.0 * (2 * Ie * D + D * Ie)
    return ops / flops.PEAK_BF16 + io / flops.PEAK_BYTES
