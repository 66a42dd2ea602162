"""Random Nemotron-H weights from a seed, drawn on the device by the
benchmark itself, for the program and the plain reference alike: the
dict that `reference/nemotron_h.py` documents (Hugging Face's (out, in)
matrices; ``embed``, ``norm_f``, ``lm_head`` and ``layers``, each layer
with ``kind``, ``norm`` and its mixer's tensors), at the distributions the
configuration's ``assumed`` states:

* every matrix and the embedding normal with std 0.02, drawn in float32 and
  rounded to the configuration's dtype; every norm scale one;
* Mamba-2: A_log = log U(1, 16); dt_bias the inverse softplus of dt, dt
  log-uniform in [time_step_min, time_step_max] and at least
  time_step_floor; D one; the convolution's weight (channels, width) and
  bias U(-1/2, 1/2);
* the router float32 with std 0.02, its correction bias N(0, 0.1^2).

The router, its bias, the convolution, dt_bias, A_log and D are float32;
everything else takes the configuration's dtype. One generator on the
device, seeded from the seed, draws the tensors in a fixed order, so the
same seed gives the same weights on any call.
"""

from __future__ import annotations

import math

import torch

STD = 0.02
ROUTER_BIAS_STD = 0.1
SALT = 24


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of the model `cfg` (its config.json keys) on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + SALT) % (1 << 63))

    def normal(*shape, std=STD, to=dtype):
        t = torch.empty(shape, dtype=torch.float32, device=device).normal_(0.0, std,
                                                                           generator=gen)
        return t.to(to)

    def uniform(n, lo, hi):
        return torch.empty(n, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)

    def ones(n, to=dtype):
        return torch.ones(n, dtype=to, device=device)

    d, v = cfg["hidden_size"], cfg["vocab_size"]
    heads, p, groups, n = (cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"],
                           cfg["ssm_state_size"])
    inner = heads * p
    conv = inner + 2 * groups * n
    width = cfg["conv_kernel"]
    hd, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    e, i, shared = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
                    cfg["moe_shared_expert_intermediate_size"])
    out = {"embed": normal(v, d), "layers": []}
    for kind in cfg["hybrid_override_pattern"]:
        layer = {"kind": kind, "norm": ones(d)}
        if kind == "M":
            dt = torch.exp(uniform(heads, math.log(cfg["time_step_min"]),
                                   math.log(cfg["time_step_max"])))
            dt = dt.clamp_min(cfg["time_step_floor"])
            layer.update(in_proj=normal(2 * inner + 2 * groups * n + heads, d),
                         conv_w=uniform((conv, width), -0.5, 0.5),
                         conv_b=uniform(conv, -0.5, 0.5),
                         dt_bias=dt + torch.log(-torch.expm1(-dt)),
                         A_log=torch.log(uniform(heads, 1.0, 16.0)),
                         D=ones(heads, torch.float32),
                         gnorm=ones(inner),
                         out_proj=normal(d, inner))
        elif kind == "*":
            layer.update(q=normal(hq * hd, d), k=normal(hkv * hd, d), v=normal(hkv * hd, d),
                         o=normal(d, hq * hd))
        elif kind == "E":
            layer.update(router=normal(e, d, to=torch.float32),
                         router_bias=normal(e, std=ROUTER_BIAS_STD, to=torch.float32),
                         up=normal(e, i, d),
                         down=normal(e, d, i),
                         shared_up=normal(shared, d),
                         shared_down=normal(d, shared))
        else:
            raise ValueError(f"no layer kind {kind!r} in Nemotron-H")
        out["layers"].append(layer)
    out["norm_f"] = ones(d)
    out["lm_head"] = normal(v, d)
    return out
