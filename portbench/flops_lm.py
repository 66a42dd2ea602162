"""Operations and bytes of the language-model cells, from their shapes:
the whole chunk's operations for `mfu.lm`, and the least time of each
launch of the experts' grouped GEMM (kernel K7) for `k7_roofline.lm`.

`cfg` is the configuration's dict (config.json keys). Operations count
two a multiply-add; a chunk's are

* every prompt token through the active parameters of each layer (the
  Mamba projections and convolution, attention's four projections, the
  router, `num_experts_per_tok` routed experts and the shared expert) and
  its causal attention (q.k and p.v over the tokens before it) and scan
  (the state's update and read-out, 4 H P N a token), and the head at each
  prompt's last position;
* every decoded token the same, at the cached context's length, with the
  head.
"""

from __future__ import annotations

import flops


def layer_counts(cfg: dict) -> dict:
    pat = cfg["hybrid_override_pattern"]
    return {k: pat.count(k) for k in "ME*"}


def token_params(cfg: dict) -> float:
    """Active weights a token multiplies through the layers (no head)."""
    D = cfg["hidden_size"]
    H, P, N, G = (cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["ssm_state_size"],
                  cfg["n_groups"])
    inner = H * P
    conv = inner + 2 * G * N
    mamba = D * (inner + conv + H) + inner * D + conv * cfg["conv_kernel"]
    attn = D * (cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"]) * cfg["head_dim"] \
        + cfg["num_attention_heads"] * cfg["head_dim"] * D
    moe = cfg["n_routed_experts"] * D + 2 * D * (
        cfg["num_experts_per_tok"] * cfg["moe_intermediate_size"]
        + cfg["moe_shared_expert_intermediate_size"])
    n = layer_counts(cfg)
    return n["M"] * mamba + n["*"] * attn + n["E"] * moe


def token_flops(cfg: dict, context: int) -> float:
    """One token's operations with `context` tokens before it (head excluded)."""
    n = layer_counts(cfg)
    attn = 4.0 * context * cfg["num_attention_heads"] * cfg["head_dim"]
    scan = 4.0 * cfg["mamba_num_heads"] * cfg["mamba_head_dim"] * cfg["ssm_state_size"]
    return 2.0 * token_params(cfg) + n["*"] * attn + n["M"] * scan


def chunk_flops(cfg: dict, lengths, new_tokens: int) -> float:
    """A chunk's operations: prompts of `lengths` tokens, then `new_tokens`
    greedy tokens each (the first from the prefill's logits)."""
    head = 2.0 * cfg["vocab_size"] * cfg["hidden_size"]
    total = 0.0
    for L in lengths:
        # sum over the prompt's positions of token_flops(cfg, i), i = 0 .. L-1
        total += L * token_flops(cfg, 0) + (token_flops(cfg, 1) - token_flops(cfg, 0)) \
            * L * (L - 1) / 2.0
        total += head  # the prompt's last position
        for s in range(1, new_tokens):
            total += token_flops(cfg, L + s - 1) + head
    return total


def expert_weight_bytes(cfg: dict) -> float:
    """One expert's weight of one K7 launch (up and down are the same size)."""
    return 2.0 * cfg["moe_intermediate_size"] * cfg["hidden_size"]


def k7_bound_s(cfg: dict, prefill_rows, decode_launches: int, decode_rows: int,
               decode_experts: int) -> float:
    """The least time of a window's K7 launches: each prefill launch of R
    rows bound by its 2 R N K operations; the decode's launches (each of
    `decode_rows` rows, `decode_experts` expert weights read in all) by
    their bytes: rows in, rows out and each expert's weight once."""
    N, K = cfg["moe_intermediate_size"], cfg["hidden_size"]
    ops = sum(2.0 * R * N * K for R in prefill_rows)
    io = decode_launches * 2.0 * decode_rows * (N + K) + decode_experts * expert_weight_bytes(cfg)
    return ops / flops.PEAK_BF16 + io / flops.PEAK_BYTES
