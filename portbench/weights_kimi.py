"""Random Kimi Linear weights from a seed, drawn on the device by the
benchmark itself, for the program and the plain reference alike: the dict
that `reference/kimi_linear.py` documents (Hugging Face's (out, in)
matrices; ``embed``, ``norm_f``, ``lm_head`` and ``layers``, each layer
with ``kind``, ``mlp``, ``attn_norm``, ``mlp_norm`` and its tensors; SwiGLU
weights with their gate and up rows interleaved in blocks of 8), at the
distributions the configuration's ``assumed`` states:

* every matrix and the embedding normal with std 0.02, drawn in float32 and
  rounded to the configuration's dtype; every norm scale one;
* KDA: A_log = log U(1, 16) a head; dt_bias the inverse softplus of dt, dt
  log-uniform in [0.001, 0.1] and at least 1e-4, a channel; the
  convolution's weight (channels, width) U(-1/2, 1/2);
* the router float32 with std 0.02 over all `num_experts_published`
  experts, its correction bias N(0, 0.1^2); the experts `expert_offset` ..
  `expert_offset + num_experts - 1`, the card's share.

The router, its bias, the convolution, dt_bias and A_log are float32;
everything else takes the configuration's dtype. One generator on the
device, seeded from the seed, draws the tensors in a fixed order, so the
same seed gives the same weights on any call.
"""

from __future__ import annotations

import math

import torch

STD = 0.02
ROUTER_BIAS_STD = 0.1
TIME_STEP = (0.001, 0.1, 1e-4)
SALT = 26


def layer_kinds(cfg: dict) -> list:
    """"kda" or "mla" for each 0-based layer (the lists are 1-based)."""
    mla = set(cfg["linear_attn_config"]["full_attn_layers"])
    return ["mla" if i + 1 in mla else "kda" for i in range(cfg["num_hidden_layers"])]


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of the model `cfg` (its config.json keys) on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + SALT) % (1 << 63))

    def normal(*shape, std=STD, to=dtype):
        t = torch.empty(shape, dtype=torch.float32, device=device).normal_(0.0, std,
                                                                           generator=gen)
        return t.to(to)

    def uniform(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi,
                                                                               generator=gen)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    d, v = cfg["hidden_size"], cfg["vocab_size"]
    la = cfg["linear_attn_config"]
    h, dk, width = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    hm, dn, dr, dv, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    e, i_e = cfg["num_experts"], cfg["moe_intermediate_size"]
    routers = cfg.get("num_experts_published") or e
    out = {"embed": normal(v, d), "layers": []}
    for i, kind in enumerate(layer_kinds(cfg)):
        layer = {"kind": kind, "attn_norm": ones(d), "mlp_norm": ones(d)}
        if kind == "kda":
            lo, hi, floor = TIME_STEP
            dt = torch.exp(uniform(h * dk, math.log(lo), math.log(hi))).clamp_min(floor)
            layer.update(qkv=normal(3 * h * dk, d),
                         conv_w=uniform((3 * h * dk, width), -0.5, 0.5),
                         f_a=normal(dk, d), f_b=normal(h * dk, dk),
                         dt_bias=dt + torch.log(-torch.expm1(-dt)),
                         A_log=torch.log(uniform(h, 1.0, 16.0)),
                         b=normal(h, d), g_a=normal(dk, d), g_b=normal(h * dk, dk),
                         o_norm=ones(dk), o=normal(d, h * dk))
        else:
            layer.update(q=normal(hm * (dn + dr), d), kv_a=normal(r + dr, d), kv_norm=ones(r),
                         kv_b=normal(hm * (dn + dv), r), o=normal(d, hm * dv))
        if i < cfg["first_k_dense_replace"]:
            layer.update(mlp="dense", gate_up=normal(2 * cfg["intermediate_size"], d),
                         down=normal(d, cfg["intermediate_size"]))
        else:
            layer.update(mlp="moe", router=normal(routers, d, to=torch.float32),
                         router_bias=normal(routers, std=ROUTER_BIAS_STD, to=torch.float32),
                         gate_up=normal(e, 2 * i_e, d), down=normal(e, d, i_e),
                         shared_gate_up=normal(2 * i_e, d), shared_down=normal(d, i_e))
        out["layers"].append(layer)
    out["norm_f"] = ones(d)
    out["lm_head"] = normal(v, d)
    return out
