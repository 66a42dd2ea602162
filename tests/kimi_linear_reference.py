"""Plain Kimi Linear in PyTorch: the whole forward pass over a batch of
sequences, written from the model's published description (Moonshot AI's
Kimi Linear report, arXiv:2510.26692; Hugging Face ``model_type``
``kimi_linear``) for holding the port's hybrid decoder to it.

Every layer is h <- h + mixer(RMSNorm(h)), then h <- h + mlp(RMSNorm(h)).
The mixer is the layer's ``kind``:

* ``kda``, Kimi Delta Attention: q, k, v = SiLU(causal depthwise
  convolution of x W_qkv, no bias); g = -exp(A_log) softplus((x W_fa) W_fb
  + dt_bias), a decay per key channel; beta = sigmoid(x W_b); per head,
  with q and k L2-normalised (eps 1e-6) and S zero at the sequence's
  start, S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t
  v_t^T and o_t = dk^-1/2 S_t^T q_t; o normalised to unit RMS over each
  head's channels, times o_norm and sigmoid((x W_ga) W_gb); W_o;
* ``mla``, multi-head latent attention without positional rotation:
  [q_nope | q_pe] = x W_q; [c | k_pe] = x W_kva; c <- RMSNorm(c) kv_norm;
  [k_nope | v] = c W_kvb a head, k_pe shared by the heads; causal softmax
  of (q_nope.k_nope + q_pe.k_pe) / sqrt(qk_nope_head_dim +
  qk_rope_head_dim); W_o.

The MLP is the layer's ``mlp``: ``dense`` SwiGLU, down(SiLU(gate x) * up
x), or ``moe``: sigmoid scores s over the router's experts, the top
``num_experts_per_token`` by s plus the correction bias, weighted by the
chosen s renormalised (``moe_renormalize``) and times
``routed_scaling_factor``, a SwiGLU expert each, plus one shared SwiGLU
expert. The experts held are ``expert_offset`` .. ``expert_offset +
num_experts - 1`` of the router's numbering (the card's share of an
expert-parallel deployment): a token's pairs routed to other experts add
nothing. A final RMSNorm (all norms eps ``rms_norm_eps``) and an untied
head give the logits.

Departures, each for exactness or for fitting beside the model on the
card: the delta rule runs token by token, never a chunked algorithm, over
the batch's sequences at once (right-padded: a sequence's padding comes
after its tokens, so nothing reaches back into them); the attention runs
one sequence at a time; the experts run one at a time in a loop.

`cfg` is a dict of the model's config.json keys; `params` a dict in
Hugging Face's (out, in) layout: ``embed``, ``norm_f``, ``lm_head`` and
``layers``, each with ``kind``, ``mlp``, ``attn_norm``, ``mlp_norm`` and
its tensors (``kda``: qkv (3 H dk, D), conv_w (3 H dk, W), f_a (dk, D),
f_b (H dk, dk), dt_bias (H dk,), A_log (H,), b (H, D), g_a (dk, D), g_b
(H dk, dk), o_norm (dk,), o (D, H dk); ``mla``: q (H (nope + rope), D),
kv_a (rank + rope, D), kv_norm (rank,), kv_b (H (nope + v), rank), o (D, H
v); ``dense``: gate_up (2 I, D), down (D, I); ``moe``: router (E_router,
D), router_bias (E_router,), gate_up (E, 2 I, D), down (E, D, I),
shared_gate_up (2 I, D), shared_down (D, I)). A SwiGLU weight holds the
gate's and the up's rows interleaved in blocks of 8: rows 16m..16m+7 are
the gate's 8m..8m+7, rows 16m+8..16m+15 the up's. The weights may be
stored in any dtype: each layer's are upcast to float32 as the layer runs,
so the float32 pass fits beside a bf16 model. Everything runs in float32
with TF32 off (`exact_fp32`). ``prec="fp8"`` is the control: the operands
of every product of the bf16 program (projections, experts, attention's
two products, the head) rounded to float8 e4m3 with one scale per tensor
and summed in float32, and what the program keeps in bf16 between
operations (projection outputs, the convolution's output, the residual
stream) kept in e4m3; norms, the gate, softmax, the router and the delta
rule stay float32, as the program keeps them. Imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # e4m3's largest finite value
L2_EPS = 1e-6
BLOCK = 8        # rows of a SwiGLU weight's gate or up block


def exact_fp32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t):
    """`t` through float8 e4m3 and back, one absmax scale for the tensor."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _store(x, prec):
    return fp8_round(x) if prec == "fp8" else x


def _mm(a, b, prec):
    """a @ b, on float8 operands in the control."""
    if prec == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return a @ b


def _linear(x, w, prec):
    """x @ w^T for a weight w (out, in) in any dtype, in float32."""
    return _store(_mm(x, w.float().t(), prec), prec)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def conv_silu(x, w):
    """Causal depthwise convolution of x (B, L, C) with w (C, W), no bias,
    then SiLU; taps before the first token read zero."""
    L, W = x.shape[1], w.shape[1]
    out = torch.zeros_like(x)
    wf = w.float()
    for j in range(W):
        s = W - 1 - j  # tokens back
        if s < L:
            out[:, s:] += x[:, : L - s] * wf[:, j]
    return F.silu(out)


def silu_gate(h):
    """SiLU(gate) * up of h (..., 2I) in the interleaved layout: (..., I)."""
    blocks = h.unflatten(-1, (-1, 2, BLOCK))
    return (F.silu(blocks[..., 0, :]) * blocks[..., 1, :]).flatten(-2)


def swiglu_mlp(x, gate_up, down, prec):
    h = _store(silu_gate(_mm(x, gate_up.float().t(), prec)), prec)
    return _mm(h, down.float().t(), prec)


def kda(p, x, cfg, prec):
    """x (B, L, D) -> (B, L, D)."""
    la = cfg["linear_attn_config"]
    H, dk = la["num_heads"], la["head_dim"]
    B, L, _ = x.shape
    qkv = _store(conv_silu(_linear(x, p["qkv"], prec), p["conv_w"]), prec)
    q, k, v = qkv.view(B, L, 3, H, dk).unbind(2)
    a = _linear(_linear(x, p["f_a"], prec), p["f_b"], prec)
    g = -torch.exp(p["A_log"].float())[:, None] * F.softplus(
        a + p["dt_bias"].float()).view(B, L, H, dk)
    alpha = torch.exp(g)
    beta = torch.sigmoid(_linear(x, p["b"], prec))                    # (B, L, H)
    q = l2norm(q) / math.sqrt(dk)
    k = l2norm(k)
    S = x.new_zeros((B, H, dk, dk))
    o = x.new_empty((B, L, H, dk))
    for t in range(L):
        S = S * alpha[:, t, :, :, None]
        kt = k[:, t].unsqueeze(-2)                                    # (B, H, 1, dk)
        u = beta[:, t, :, None] * (v[:, t] - (kt @ S).squeeze(-2))    # (B, H, dv)
        S = S + kt.transpose(-1, -2) * u.unsqueeze(-2)
        o[:, t] = (q[:, t].unsqueeze(-2) @ S).squeeze(-2)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    gate = _linear(_linear(x, p["g_a"], prec), p["g_b"], prec).view(B, L, H, dk)
    o = _store((o * p["o_norm"].float() * torch.sigmoid(gate)).reshape(B, L, H * dk), prec)
    return _linear(o, p["o"], prec)


def mla(p, x, lengths, cfg, prec):
    """x (B, L, D) of sequences of `lengths` tokens -> (B, L, D), padding
    rows zero."""
    H, dn, dr, dv, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])
    B, L, _ = x.shape
    q = _linear(x, p["q"], prec).view(B, L, H, dn + dr)
    ckv = _linear(x, p["kv_a"], prec)
    c = _store(rms_norm(ckv[..., :r], p["kv_norm"], cfg["rms_norm_eps"]), prec)
    kv = _linear(c, p["kv_b"], prec).view(B, L, H, dn + dv)
    k = torch.cat([kv[..., :dn], ckv[..., None, r:].expand(B, L, H, dr)], -1)
    o = x.new_zeros((B, L, H, dv))
    for b, n in enumerate(lengths):
        qb, kb, vb = (t[b, :n].transpose(0, 1) for t in (q, k, kv[..., dn:]))
        logits = _mm(qb, kb.transpose(1, 2), prec) / math.sqrt(dn + dr)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        o[b, :n] = _mm(probs, vb, prec).transpose(0, 1)
        del logits, probs
    return _linear(_store(o.reshape(B, L, H * dv), prec), p["o"], prec)


def route(p, x, cfg, chosen=None):
    """(expert ids (N, k), weights (N, k)) of the normed rows x: the top k by
    the biased scores, or the rows' forced sets where `chosen` (N, k)
    holds one (rows of -1 are not forced), gated by the unbiased scores
    either way."""
    scores = torch.sigmoid(x @ p["router"].float().t())
    idx = torch.topk(scores + p["router_bias"].float(), cfg["num_experts_per_token"],
                     dim=-1).indices
    if chosen is not None:
        forced = chosen[:, 0] >= 0
        idx = torch.where(forced[:, None], chosen, idx)
    w = scores.gather(1, idx)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(p, x, cfg, prec, routes, chosen=None):
    """x (N, D) -> (N, D); appends the ids the layer would choose (N, k)."""
    own, _ = route(p, x, cfg)
    routes.append(own)
    idx, w = route(p, x, cfg, chosen)
    lo = cfg.get("expert_offset", 0)
    out = torch.zeros_like(x)
    for e in range(p["gate_up"].shape[0]):
        tok, slot = torch.nonzero(idx == lo + e, as_tuple=True)
        if tok.numel():
            y = swiglu_mlp(x[tok], p["gate_up"][e], p["down"][e], prec)
            out.index_add_(0, tok, y * w[tok, slot, None])
    out += swiglu_mlp(x, p["shared_gate_up"], p["shared_down"], prec)
    return _store(out, prec)


@torch.no_grad()
def forward_batch(params, cfg: dict, seqs, prec: str = "fp32", logits_from=None, chosen=None):
    """seqs, a list of id tensors (L_b,) -> a list of (logits (L_b -
    logits_from[b], vocab) of sequence b's positions from logits_from[b]
    on, the expert ids (L_b, k) each MoE layer would choose, in order).
    `chosen[b]`, a list of (n_b, k) expert ids a MoE layer, forces each
    layer's choice for sequence b's first n_b tokens (gated by the layer's
    own scores): the reference teacher-forced on another model's routing."""
    dev = params["embed"].device
    lengths = [len(s) for s in seqs]
    B, L = len(seqs), max(lengths)
    logits_from = logits_from or [0] * B
    ids = torch.zeros((B, L), dtype=torch.long, device=dev)
    valid = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for b, s in enumerate(seqs):
        ids[b, : len(s)] = s.to(dev)
        valid[b, : len(s)] = True
    h = _store(params["embed"][ids].float(), prec)
    eps = cfg["rms_norm_eps"]
    routes = []
    for p in params["layers"]:
        x = rms_norm(h, p["attn_norm"], eps)
        out = kda(p, x, cfg, prec) if p["kind"] == "kda" else mla(p, x, lengths, cfg, prec)
        h = _store(h + out, prec)
        x = rms_norm(h, p["mlp_norm"], eps)
        if p["mlp"] == "dense":
            out = swiglu_mlp(x, p["gate_up"], p["down"], prec)
        else:
            forced = None
            if chosen is not None:
                forced = torch.full((B, L, cfg["num_experts_per_token"]), -1, dtype=torch.long,
                                    device=dev)
                for b in range(B):
                    c = chosen[b][len(routes) // B].to(dev)
                    forced[b, : len(c)] = c
                forced = forced[valid]
            flat = torch.zeros_like(x)
            own = []
            flat[valid] = moe(p, x[valid], cfg, prec, own, forced)
            out = flat
            starts = [0] + list(torch.cumsum(torch.tensor(lengths), 0).tolist())
            routes += [own[0][starts[b]:starts[b + 1]] for b in range(B)]
        h = _store(h + out, prec)
        del x, out
    n_moe = len(routes) // B
    result = []
    for b in range(B):
        x = rms_norm(h[b, logits_from[b]: lengths[b]], params["norm_f"], eps)
        logits = _mm(x, params["lm_head"].float().t(), prec)
        result.append((logits, [routes[i * B + b] for i in range(n_moe)]))
    return result

