"""Nemotron-H, a hybrid decoder of Mamba-2 mixers, mixtures of experts and
grouped-query attention (NVIDIA-Nemotron-3-Nano-30B-A3B at the defaults
of `config.NemotronHConfig`): VidIL's language-model stage on the card
(`pipeline/lm_answer.py`).

Every layer is ``x <- x + mixer(RMSNorm(x))`` (eps ``norm_eps``), the
mixer of the layer's kind:

* ``M``, Mamba-2: in_proj -> z, xBC, dt; xBC through a causal depthwise
  convolution (width ``conv_kernel``, with bias) and SiLU, split into x,
  B and C (``n_groups`` groups of ``ssm_state_size``); dt = softplus(dt +
  dt_bias), A = -exp(A_log); the SSD recurrence per head, h <- exp(dt A) h
  + dt x B^T, y = h C + D x; the gated RMSNorm over groups of
  ``mamba_inner / n_groups`` channels; out_proj (`ops/ssd.py`);
* ``*``, attention: q, k, v projections without bias, causal softmax
  attention with ``num_key_value_heads`` key/value heads, no positional
  rotation (Nemotron-H's attention layers are position-free), o_proj;
* ``E``, mixture of experts (`ops/moe.py`).

A final RMSNorm and an untied head project only the positions that are
decoded. Weights (`init_nemotron_h`) are one dict of tensors in Hugging
Face's (out, in) layout; the experts of a layer are stacked, up (E, I, D)
and down (E, D, I), the layout the grouped GEMM reads.

The hybrid cache (`init_cache`) holds, per attention layer, keys and
values (B, kv heads, capacity, head dim) with each row's length, and per
Mamba layer the convolution state (B, conv_dim, conv_kernel - 1) and the
SSM state (B, H, P, N) in float32, whatever the length. `prefill` runs
packed prompts of unequal length and fills row b of the cache with prompt
b; `step` feeds one token a row; `reorder_cache` gathers rows (a beam
search's reorder). These fill `ops/generation.py`'s prefill/step/reorder
slots; `greedy_search` there drives them.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from vidil_tpu_torch.config import NemotronHConfig
from vidil_tpu_torch.ops import moe, ssd
from vidil_tpu_torch.utils.profiling import annotate

STD = 0.02


def _normal(shape, gen, device, dtype):
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, STD, generator=gen)


def _uniform(shape, lo, hi, gen, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)


def init_nemotron_h(cfg: NemotronHConfig, gen: torch.Generator, device,
                    dtype=torch.bfloat16) -> dict:
    """Seeded weights: every matrix and the embedding normal with std 0.02
    in `dtype`; norm scales one; A_log = log U(1, 16); dt_bias the inverse
    softplus of dt, dt log-uniform in [time_step_min, time_step_max] and
    at least time_step_floor; D one; the convolution's weight and bias
    U(-1/2, 1/2) (PyTorch's Conv1d default at a fan-in of 4); the router
    float32 with std 0.02 and a correction bias N(0, 0.1^2). Small
    vectors are float32."""
    D, V = cfg.hidden_size, cfg.vocab_size
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)  # noqa: E731
    p = {"embed": _normal((V, D), gen, device, dtype), "layers": []}
    for kind in cfg.hybrid_override_pattern:
        layer = {"kind": kind, "norm": ones(D)}
        if kind == "M":
            H, W = cfg.mamba_num_heads, cfg.conv_kernel
            bound = 1.0 / math.sqrt(W)
            dt = torch.exp(_uniform((H,), math.log(cfg.time_step_min),
                                    math.log(cfg.time_step_max), gen, device))
            dt = dt.clamp_min(cfg.time_step_floor)
            layer.update(
                in_proj=_normal((cfg.in_proj_size, D), gen, device, dtype),
                conv_w=_uniform((cfg.conv_dim, W), -bound, bound, gen, device),
                conv_b=_uniform((cfg.conv_dim,), -bound, bound, gen, device),
                dt_bias=dt + torch.log(-torch.expm1(-dt)),
                A_log=torch.log(_uniform((H,), 1.0, 16.0, gen, device)),
                D=torch.ones(H, dtype=torch.float32, device=device),
                gnorm=ones(cfg.mamba_inner),
                out_proj=_normal((D, cfg.mamba_inner), gen, device, dtype))
        elif kind == "*":
            hd = cfg.head_dim
            layer.update(q=_normal((cfg.num_attention_heads * hd, D), gen, device, dtype),
                         k=_normal((cfg.num_key_value_heads * hd, D), gen, device, dtype),
                         v=_normal((cfg.num_key_value_heads * hd, D), gen, device, dtype),
                         o=_normal((D, cfg.num_attention_heads * hd), gen, device, dtype))
        else:
            E, I, Is = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                        cfg.moe_shared_expert_intermediate_size)
            layer.update(router=_normal((E, D), gen, device, torch.float32),
                         router_bias=torch.empty(E, device=device).normal_(0.0, 0.1,
                                                                           generator=gen),
                         up=_normal((E, I, D), gen, device, dtype),
                         down=_normal((E, D, I), gen, device, dtype),
                         shared_up=_normal((Is, D), gen, device, dtype),
                         shared_down=_normal((D, Is), gen, device, dtype))
        p["layers"].append(layer)
    p["norm_f"] = ones(D)
    p["lm_head"] = _normal((V, D), gen, device, dtype)
    return p


def rms_norm(x, weight, eps: float):
    """x / rms(x) in float32, rounded to x's dtype, times the weight."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return xf.to(x.dtype) * weight


# ---------------------------------------------------------------------------
# the hybrid cache
# ---------------------------------------------------------------------------

def init_cache(cfg: NemotronHConfig, batch: int, capacity: int, device,
               dtype=torch.bfloat16) -> dict:
    """An empty cache for `batch` rows of up to `capacity` tokens: per
    layer index, ``k``/``v`` (attention) or ``conv``/``ssm`` (Mamba), and
    ``lengths`` (batch,) int64."""
    cache = {"lengths": torch.zeros(batch, dtype=torch.int64, device=device)}
    for i, kind in enumerate(cfg.hybrid_override_pattern):
        if kind == "*":
            shape = (batch, cfg.num_key_value_heads, capacity, cfg.head_dim)
            cache[f"k{i}"] = torch.zeros(shape, dtype=dtype, device=device)
            cache[f"v{i}"] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "M":
            cache[f"conv{i}"] = torch.zeros((batch, cfg.conv_dim, cfg.conv_kernel - 1),
                                            dtype=dtype, device=device)
            cache[f"ssm{i}"] = torch.zeros((batch, cfg.mamba_num_heads, cfg.mamba_head_dim,
                                            cfg.ssm_state_size), dtype=torch.float32,
                                           device=device)
    return cache


def reorder_cache(cache: dict, idx) -> dict:
    """Rows gathered by idx (a beam search's reorder)."""
    return {k: v.index_select(0, idx) for k, v in cache.items()}


def cache_capacity(cache: dict) -> int:
    return next(v.shape[2] for k, v in cache.items() if k.startswith("k"))


# ---------------------------------------------------------------------------
# mixers: packed prefill and one decode token
# ---------------------------------------------------------------------------

def _split_in_proj(zxbcdt, cfg):
    inner, conv = cfg.mamba_inner, cfg.conv_dim
    return zxbcdt[..., :inner], zxbcdt[..., inner:inner + conv], zxbcdt[..., inner + conv:]


def _split_xbc(xbc, cfg):
    inner, gn = cfg.mamba_inner, cfg.n_groups * cfg.ssm_state_size
    lead = xbc.shape[:-1]
    x = xbc[..., :inner].reshape(*lead, cfg.mamba_num_heads, cfg.mamba_head_dim)
    B = xbc[..., inner:inner + gn].reshape(*lead, cfg.n_groups, cfg.ssm_state_size)
    C = xbc[..., inner + gn:].reshape(*lead, cfg.n_groups, cfg.ssm_state_size)
    return x, B, C


def mamba_prefill(p, x, cfg, packed, cache, i):
    n = len(packed.packing.lengths)
    z, xbc, dt = _split_in_proj(F.linear(x, p["in_proj"]), cfg)
    cache[f"conv{i}"][:n] = ssd.conv_state_packed(xbc, packed, cfg.conv_kernel)
    xbc = ssd.causal_conv_packed(xbc, p["conv_w"], p["conv_b"], packed)
    xs, B, C = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    y, state = ssd.ssd_chunked(xs, dt, -torch.exp(p["A_log"]), B, C, p["D"], packed.layout, n,
                               cfg.chunk_size)
    cache[f"ssm{i}"][:n] = state
    y = ssd.gated_rms_norm(y.reshape(y.shape[0], -1), z, p["gnorm"],
                           cfg.mamba_inner // cfg.n_groups, cfg.norm_eps, x.dtype)
    return F.linear(y, p["out_proj"])


def mamba_step(p, x, cfg, cache, i):
    z, xbc, dt = _split_in_proj(F.linear(x, p["in_proj"]), cfg)
    xbc = ssd.conv_step(cache[f"conv{i}"], xbc, p["conv_w"], p["conv_b"])
    xs, B, C = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    y = ssd.ssd_step(cache[f"ssm{i}"], xs, dt, -torch.exp(p["A_log"]), B, C, p["D"])
    y = ssd.gated_rms_norm(y.reshape(y.shape[0], -1), z, p["gnorm"],
                           cfg.mamba_inner // cfg.n_groups, cfg.norm_eps, x.dtype)
    return F.linear(y, p["out_proj"])


def attention_prefill(p, x, cfg, packing, cache, i):
    """Causal attention within each prompt (SDPA, one call a prompt, the
    query heads grouped over the key/value heads); the prompt's keys and
    values go to its cache row. On the card the call is held to the flash
    kernel: the default choice there builds a cuDNN plan for each new
    prompt length, ~12 ms of host time a prompt on an H100 host, which the
    device waits out."""
    hd, Hq, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    q, k, v = F.linear(x, p["q"]), F.linear(x, p["k"]), F.linear(x, p["v"])
    out = torch.empty_like(q)
    flash = sdpa_kernel(SDPBackend.FLASH_ATTENTION) if x.is_cuda else contextlib.nullcontext()
    with flash:
        for b, (s, n) in enumerate(zip(packing.starts.tolist(), packing.lengths)):
            qb = q[s:s + n].view(n, Hq, hd).transpose(0, 1)[None]
            kb = k[s:s + n].view(n, Hkv, hd).transpose(0, 1)
            vb = v[s:s + n].view(n, Hkv, hd).transpose(0, 1)
            cache[f"k{i}"][b, :, :n] = kb
            cache[f"v{i}"][b, :, :n] = vb
            ob = F.scaled_dot_product_attention(qb, kb[None], vb[None], is_causal=True,
                                                enable_gqa=True)
            out[s:s + n] = ob[0].transpose(0, 1).reshape(n, Hq * hd)
    return F.linear(out, p["o"])


def attention_step(p, x, cfg, cache, i):
    """One token a row over its cached keys: row b's new key and value go
    to position lengths[b], and the row attends to positions 0..lengths[b]
    (float32 logits and softmax, one rounding of the output)."""
    hd, Hq, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    Bt = x.shape[0]
    lengths = cache["lengths"]
    kc, vc = cache[f"k{i}"], cache[f"v{i}"]
    rows = torch.arange(Bt, device=x.device)
    kc[rows, :, lengths] = F.linear(x, p["k"]).view(Bt, Hkv, hd)
    vc[rows, :, lengths] = F.linear(x, p["v"]).view(Bt, Hkv, hd)
    q = F.linear(x, p["q"]).view(Bt, Hkv, Hq // Hkv, hd).float()
    logits = torch.matmul(q, kc.float().transpose(2, 3)) / math.sqrt(hd)  # (B, Hkv, G, cap)
    seen = torch.arange(kc.shape[2], device=x.device)[None] <= lengths[:, None]
    logits = logits.masked_fill(~seen[:, None, None, :], float("-inf"))
    o = torch.matmul(torch.softmax(logits, dim=-1), vc.float())
    return F.linear(o.reshape(Bt, Hq * hd).to(x.dtype), p["o"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def logits_of(params, h, cfg):
    """Final norm and head of the rows of h: (n, vocab) float32."""
    return F.linear(rms_norm(h, params["norm_f"], cfg.norm_eps), params["lm_head"]).float()


def prefill(params, cfg: NemotronHConfig, ids, packed: ssd.Packed, cache: dict, probe=None):
    """Packed prompts ids (T,) through every layer (`packed`: their
    `ssd.pack` on the device); row b of the cache gets prompt b. Returns
    each prompt's last-position logits (P, vocab) float32. `probe` (a
    dict), when given, collects each MoE layer's expert ids."""
    packing = packed.packing
    if cache_capacity(cache) < max(packing.lengths) + 1:
        raise ValueError(f"a prompt of {max(packing.lengths)} tokens leaves no room in a cache "
                         f"of {cache_capacity(cache)}")
    h = params["embed"][ids]
    for i, p in enumerate(params["layers"]):
        x = rms_norm(h, p["norm"], cfg.norm_eps)
        if p["kind"] == "M":
            with annotate("lm.mamba"):
                out = mamba_prefill(p, x, cfg, packed, cache, i)
        elif p["kind"] == "*":
            with annotate("lm.attention"):
                out = attention_prefill(p, x, cfg, packing, cache, i)
        else:
            out = moe.moe_layer(p, x, cfg, probe)
        del x
        h = h + out
        del out
    cache["lengths"][: len(packing.lengths)] = packed.lengths
    return logits_of(params, h[packed.ends - 1], cfg)


def step(params, cfg: NemotronHConfig, tokens, cache: dict, probe=None):
    """One token a row (tokens (B,)) at each row's length; the cache is
    updated in place and its lengths advanced. Returns (B, vocab) float32
    logits."""
    h = params["embed"][tokens]
    for i, p in enumerate(params["layers"]):
        x = rms_norm(h, p["norm"], cfg.norm_eps)
        if p["kind"] == "M":
            with annotate("lm.mamba"):
                out = mamba_step(p, x, cfg, cache, i)
        elif p["kind"] == "*":
            with annotate("lm.attention"):
                out = attention_step(p, x, cfg, cache, i)
        else:
            out = moe.moe_layer(p, x, cfg, probe)
        h = h + out
    cache["lengths"] += 1
    return logits_of(params, h, cfg)
