"""Kimi Linear, a hybrid decoder of gated delta-rule (KDA) layers,
multi-head latent attention (MLA) and mixtures of experts
(Kimi-Linear-48B-A3B-Instruct at the defaults of
`config.KimiLinearConfig`): the second model of VidIL's language-model
stage on the card (`pipeline/lm_answer.py`).

Every layer is ``h <- h + mixer(RMSNorm(h)); h <- h + mlp(RMSNorm(h))``
(eps ``rms_norm_eps``), the mixer of the layer's kind:

* ``kda``: q, k, v = SiLU(causal depthwise convolution (width
  ``short_conv_kernel_size``, no bias) of x W_qkv); the decay per key
  channel g = -exp(A_log) softplus((x W_fa) W_fb + dt_bias); beta =
  sigmoid(x W_b); the gated delta rule over L2-normalised q and k
  (`ops/kda.py`); the output normalised per head, times sigmoid((x W_ga)
  W_gb), then W_o;
* ``mla``: latent attention without positional rotation (``mla_use_nope``):
  [q_nope | q_pe] = x W_q; [c | k_pe] = x W_kva, c <- RMSNorm(c);
  [k_nope | v] = c W_kvb a head, k_pe shared by the heads; causal softmax
  of (q_nope.k_nope + q_pe.k_pe) / sqrt(nope + rope dims); W_o.

The MLP is dense SwiGLU in the first ``first_k_dense_replace`` layers and a
mixture of experts after (`ops/moe.py`: sigmoid routing over
``router_experts`` with a correction bias that only selects, renormalised
and scaled; SwiGLU experts of the held range `expert_range` on K7; one
shared SwiGLU expert). A final RMSNorm and an untied head project the
positions that are decoded.

Weights (`init_kimi_linear`) are one dict of tensors in Hugging Face's
(out, in) layout, the layout `tests/kimi_linear_reference.py` documents:
``embed``, ``norm_f``, ``lm_head`` and ``layers``, each layer with
``kind`` (``kda`` or ``mla``), ``mlp`` (``dense`` or ``moe``), the norms
``attn_norm`` and ``mlp_norm``, and its mixer's and MLP's tensors. A SwiGLU
weight holds its gate and up rows interleaved in blocks of 8
(`grouped_expert_gemm.SWIGLU_BLOCK`), the layout in which K7 takes both in one
tile.

The hybrid cache (`init_cache`): per MLA layer its latent rows (B,
capacity, kv_lora_rank + qk_rope_head_dim), the normed c and k_pe of each
token, shared by all heads; per KDA layer the convolution state (B, 3 H
dk, width - 1) and the delta rule's state (B, H, dk, dv) in float32,
whatever the length; each row's length. `prefill` runs packed prompts of
unequal length (MLA expanded into per-head keys and values, one SDPA call
a prompt) and fills row b with prompt b; `step` feeds one token a row,
MLA absorbed into the latent rows (q through the K half of W_kvb, the
attention over the latent rows, the output through the V half).

Spans (`utils/profiling.py:annotate`): ``lm.kda`` (a KDA mixer, holding
``lm.kda_scan``, the chunked rule of the prefill), ``lm.mla``, ``lm.dense``
and `ops/moe.py`'s ``lm.route`` and ``lm.experts``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from vidil_tpu_torch.config import KimiLinearConfig
from vidil_tpu_torch.models.nemotron_h import rms_norm
from vidil_tpu_torch.ops import kda, moe, ssd
from vidil_tpu_torch.utils.profiling import annotate

STD = 0.02
TIME_STEP = (0.001, 0.1, 1e-4)  # dt's range and floor for dt_bias (Mamba's, as fla's KDA)


def init_kimi_linear(cfg: KimiLinearConfig, gen: torch.Generator, device,
                     dtype=torch.bfloat16) -> dict:
    """Seeded weights: every matrix and the embedding normal with std 0.02
    in `dtype`; norm scales one; A_log = log U(1, 16) a head; dt_bias the
    inverse softplus of dt, dt log-uniform in [0.001, 0.1] and at least
    1e-4, a channel; the convolution's weight U(-1/2, 1/2); the router
    float32 with std 0.02 and a correction bias N(0, 0.1^2). Small vectors
    are float32."""
    D, V = cfg.hidden_size, cfg.vocab_size
    H, dk = cfg.kda_heads, cfg.kda_head_dim
    Hm = cfg.num_attention_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank

    def normal(*shape, to=dtype):
        return torch.empty(shape, dtype=to, device=device).normal_(0.0, STD, generator=gen)

    def uniform(n, lo, hi):
        return torch.empty(n, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    p = {"embed": normal(V, D), "layers": []}
    for i, kind in enumerate(cfg.layer_kinds):
        layer = {"kind": kind, "attn_norm": ones(D), "mlp_norm": ones(D)}
        if kind == "kda":
            lo, hi, floor = TIME_STEP
            dt = torch.exp(uniform(H * dk, math.log(lo), math.log(hi))).clamp_min(floor)
            layer.update(qkv=normal(3 * H * dk, D),
                         conv_w=uniform((3 * H * dk, cfg.conv_kernel), -0.5, 0.5),
                         f_a=normal(dk, D), f_b=normal(H * dk, dk),
                         dt_bias=dt + torch.log(-torch.expm1(-dt)),
                         A_log=torch.log(uniform(H, 1.0, 16.0)),
                         b=normal(H, D), g_a=normal(dk, D), g_b=normal(H * dk, dk),
                         o_norm=ones(dk), o=normal(D, H * dk))
        else:
            layer.update(q=normal(Hm * (dn + dr), D), kv_a=normal(r + dr, D), kv_norm=ones(r),
                         kv_b=normal(Hm * (dn + dv), r), o=normal(D, Hm * dv))
        if i < cfg.first_k_dense_replace:
            layer.update(mlp="dense", gate_up=normal(2 * cfg.intermediate_size, D),
                         down=normal(D, cfg.intermediate_size))
        else:
            E, I = cfg.num_experts, cfg.moe_intermediate_size
            layer.update(mlp="moe", router=normal(cfg.router_experts, D, to=torch.float32),
                         router_bias=torch.empty(cfg.router_experts, device=device).normal_(
                             0.0, 0.1, generator=gen),
                         gate_up=normal(E, 2 * I, D), down=normal(E, D, I),
                         shared_gate_up=normal(2 * I, D), shared_down=normal(D, I))
        p["layers"].append(layer)
    p["norm_f"] = ones(D)
    p["lm_head"] = normal(V, D)
    return p


# ---------------------------------------------------------------------------
# the hybrid cache
# ---------------------------------------------------------------------------

def init_cache(cfg: KimiLinearConfig, batch: int, capacity: int, device,
               dtype=torch.bfloat16) -> dict:
    """An empty cache for `batch` rows of up to `capacity` tokens: per
    layer index, ``lat`` (MLA) or ``conv``/``kda`` (KDA), and ``lengths``
    (batch,) int64."""
    cache = {"lengths": torch.zeros(batch, dtype=torch.int64, device=device)}
    H, dk = cfg.kda_heads, cfg.kda_head_dim
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "mla":
            cache[f"lat{i}"] = torch.zeros((batch, capacity,
                                            cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                                           dtype=dtype, device=device)
        else:
            cache[f"conv{i}"] = torch.zeros((batch, 3 * H * dk, cfg.conv_kernel - 1),
                                            dtype=dtype, device=device)
            cache[f"kda{i}"] = torch.zeros((batch, H, dk, dk), dtype=torch.float32,
                                           device=device)
    return cache


def cache_capacity(cache: dict) -> int:
    return next(v.shape[1] for k, v in cache.items() if k.startswith("lat"))


# ---------------------------------------------------------------------------
# mixers: packed prefill and one decode token
# ---------------------------------------------------------------------------

def _kda_inputs(p, x, qkv, cfg):
    """q, k, v (rows, H, dk) views of the convolved qkv; the gate's g
    (rows, H, dk) and beta (rows, H), float32."""
    H, dk = cfg.kda_heads, cfg.kda_head_dim
    q, k, v = qkv.view(qkv.shape[0], 3, H, dk).unbind(1)
    g = kda.gate(F.linear(F.linear(x, p["f_a"]), p["f_b"]), p["A_log"], p["dt_bias"])
    beta = torch.sigmoid(F.linear(x, p["b"]).float())
    return q, k, v, g, beta


def _kda_out(p, x, o, cfg):
    gate_in = F.linear(F.linear(x, p["g_a"]), p["g_b"])
    return F.linear(kda.gated_norm(o, gate_in, p["o_norm"], cfg.rms_norm_eps, x.dtype), p["o"])


def kda_prefill(p, x, cfg, packed, cache, i):
    n = len(packed.packing.lengths)
    qkv = F.linear(x, p["qkv"])
    cache[f"conv{i}"][:n] = ssd.conv_state_packed(qkv, packed, cfg.conv_kernel)
    qkv = ssd.causal_conv_packed(qkv, p["conv_w"], None, packed)
    q, k, v, g, beta = _kda_inputs(p, x, qkv, cfg)
    with annotate("lm.kda_scan"):
        o, state = kda.kda_chunked(q, k, v, g, beta, packed.layout, n, cfg.chunk_size)
    del q, k, v, g, qkv
    cache[f"kda{i}"][:n] = state
    return _kda_out(p, x, o, cfg)


def kda_step(p, x, cfg, cache, i):
    qkv = ssd.conv_step(cache[f"conv{i}"], F.linear(x, p["qkv"]), p["conv_w"], None)
    q, k, v, g, beta = _kda_inputs(p, x, qkv, cfg)
    o = kda.kda_step(cache[f"kda{i}"], q, k, v, g, beta)
    return _kda_out(p, x, o, cfg)


def latent_norm(c, weight, eps: float):
    """The latent's RMSNorm (a name of its own, so a test can replace it)."""
    return rms_norm(c, weight, eps)


def _latent(p, x, cfg):
    """Each row's latent [RMSNorm(c) | k_pe] (rows, r + rope) in x's dtype."""
    r = cfg.kv_lora_rank
    ckv = F.linear(x, p["kv_a"])
    return torch.cat([latent_norm(ckv[:, :r], p["kv_norm"], cfg.rms_norm_eps), ckv[:, r:]], -1)


def mla_prefill(p, x, cfg, packing, cache, i):
    """Causal latent attention within each prompt, the latent expanded into
    per-head keys [k_nope | k_pe] and values (padded with zeros to the
    keys' width, which the flash kernel asks for), one SDPA call a prompt;
    each prompt's latent rows go to its cache row. On the card the call is
    held to the flash kernel, as `nemotron_h.attention_prefill`'s is."""
    H, dn, dr, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    T = x.shape[0]
    q = F.linear(x, p["q"]).view(T, H, dn + dr)
    lat = _latent(p, x, cfg)
    kv = F.linear(lat[:, :r], p["kv_b"]).view(T, H, dn + dv)
    k = torch.cat([kv[..., :dn], lat[:, None, r:].expand(T, H, dr)], -1)
    v = F.pad(kv[..., dn:], (0, dn + dr - dv))
    del kv
    out = x.new_empty((T, H, dv))
    flash = sdpa_kernel(SDPBackend.FLASH_ATTENTION) if x.is_cuda else contextlib.nullcontext()
    with flash:
        for b, (s, n) in enumerate(zip(packing.starts.tolist(), packing.lengths)):
            cache[f"lat{i}"][b, :n] = lat[s:s + n]
            ob = F.scaled_dot_product_attention(q[s:s + n].transpose(0, 1)[None],
                                                k[s:s + n].transpose(0, 1)[None],
                                                v[s:s + n].transpose(0, 1)[None], is_causal=True)
            out[s:s + n] = ob[0, :, :, :dv].transpose(0, 1)
    return F.linear(out.view(T, H * dv), p["o"])


def mla_step(p, x, cfg, cache, i):
    """One token a row, absorbed into the latent rows: row b's latent goes
    to position lengths[b]; q_nope through the K half of W_kvb meets the
    latent c, q_pe meets k_pe, over positions 0..lengths[b] (float32
    logits and softmax); the attended latent goes through the V half of
    W_kvb. One rounding of the output."""
    H, dn, dr, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    Bt = x.shape[0]
    lengths = cache["lengths"]
    lc = cache[f"lat{i}"]
    lc[torch.arange(Bt, device=x.device), lengths] = _latent(p, x, cfg)
    q = F.linear(x, p["q"]).view(Bt, H, dn + dr).float()
    w_kv = p["kv_b"].view(H, dn + dv, r).float()
    q_lat = torch.matmul(q[..., :dn].unsqueeze(-2), w_kv[:, :dn]).squeeze(-2)    # (B, H, r)
    lf = lc.float()
    logits = torch.matmul(torch.cat([q_lat, q[..., dn:]], -1), lf.transpose(1, 2))
    logits = logits / math.sqrt(dn + dr)                                         # (B, H, cap)
    seen = torch.arange(lc.shape[1], device=x.device)[None] <= lengths[:, None]
    logits = logits.masked_fill(~seen[:, None, :], float("-inf"))
    o_lat = torch.matmul(torch.softmax(logits, dim=-1), lf[..., :r])              # (B, H, r)
    o = torch.matmul(o_lat.unsqueeze(-2), w_kv[:, dn:].transpose(1, 2)).squeeze(-2)
    return F.linear(o.reshape(Bt, H * dv).to(x.dtype), p["o"])


def mlp(p, x, cfg, probe=None):
    """The layer's MLP on normed x: dense SwiGLU or the mixture of experts
    over the held range."""
    if p["mlp"] == "dense":
        with annotate("lm.dense"):
            return moe.shared_expert(x, p["gate_up"], p["down"], "swiglu")
    return moe.moe_layer(p, x, cfg, probe, first=cfg.expert_offset)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def logits_of(params, h, cfg):
    """Final norm and head of the rows of h: (n, vocab) float32."""
    return F.linear(rms_norm(h, params["norm_f"], cfg.rms_norm_eps), params["lm_head"]).float()


def prefill(params, cfg: KimiLinearConfig, ids, packed: ssd.Packed, cache: dict, probe=None):
    """Packed prompts ids (T,) through every layer (`packed`: their
    `ssd.pack` on the device, in chunks of ``cfg.chunk_size``); row b of
    the cache gets prompt b. Returns each prompt's last-position logits
    (P, vocab) float32. `probe` (a dict), when given, collects each MoE
    layer's expert ids."""
    packing = packed.packing
    if cache_capacity(cache) < max(packing.lengths) + 1:
        raise ValueError(f"a prompt of {max(packing.lengths)} tokens leaves no room in a cache "
                         f"of {cache_capacity(cache)}")
    eps = cfg.rms_norm_eps
    h = params["embed"][ids]
    for i, p in enumerate(params["layers"]):
        x = rms_norm(h, p["attn_norm"], eps)
        if p["kind"] == "kda":
            with annotate("lm.kda"):
                out = kda_prefill(p, x, cfg, packed, cache, i)
        else:
            with annotate("lm.mla"):
                out = mla_prefill(p, x, cfg, packing, cache, i)
        h = h + out
        del x, out
        out = mlp(p, rms_norm(h, p["mlp_norm"], eps), cfg, probe)
        h = h + out
        del out
    cache["lengths"][: len(packing.lengths)] = packed.lengths
    return logits_of(params, h[packed.ends - 1], cfg)


def step(params, cfg: KimiLinearConfig, tokens, cache: dict, probe=None):
    """One token a row (tokens (B,)) at each row's length; the cache is
    updated in place and its lengths advanced. Returns (B, vocab) float32
    logits."""
    eps = cfg.rms_norm_eps
    h = params["embed"][tokens]
    for i, p in enumerate(params["layers"]):
        x = rms_norm(h, p["attn_norm"], eps)
        if p["kind"] == "kda":
            with annotate("lm.kda"):
                out = kda_step(p, x, cfg, cache, i)
        else:
            with annotate("lm.mla"):
                out = mla_step(p, x, cfg, cache, i)
        h = h + out
        h = h + mlp(p, rms_norm(h, p["mlp_norm"], eps), cfg, probe)
    cache["lengths"] += 1
    return logits_of(params, h, cfg)
