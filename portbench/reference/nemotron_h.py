"""Plain Nemotron-H in PyTorch: the whole forward pass over one sequence,
written from the model's published description (Hugging Face
``modeling_nemotron_h``, ``model_type`` ``nemotron_h``; Mamba-2, Dao and
Gu 2024) for holding the port's hybrid decoder to it.

Every layer is x <- x + mixer(RMSNorm(x)); the mixer is the layer's kind
in ``hybrid_override_pattern``: ``M`` Mamba-2, ``*`` causal grouped-query
attention without positional rotation, ``E`` a mixture of experts with
sigmoid routing, a correction bias that only selects, normalised top-k
weights times ``routed_scaling_factor``, relu^2 experts and one shared
expert. A final RMSNorm and an untied head give the logits.

Departures, each for exactness: the Mamba-2 scan is its quadratic masked
(dual) form over the whole sequence, y_i = D x_i + sum_{j<=i} (C_i . B_j)
exp(sum_{j<k<=i} dt_k A) dt_j x_j, never a chunked algorithm, with the
sums of dt A taken in float64 so that their differences keep float32's
precision; the experts run one at a time in a loop.

`cfg` is a dict of the model's config.json keys; `params` a dict in
Hugging Face's (out, in) layout: ``embed``, ``norm_f``, ``lm_head`` and
``layers``, each with ``kind``, ``norm`` and its mixer's tensors (``M``:
in_proj, conv_w (C, W), conv_b, dt_bias, A_log, D, gnorm, out_proj; ``*``:
q, k, v, o; ``E``: router, router_bias, up (E, I, D), down (E, D, I),
shared_up, shared_down). The weights may be stored in any dtype: each
layer's are upcast to float32 as the layer runs, so the float32 pass fits
beside a bf16 model. Everything runs in float32 with TF32 off
(`exact_fp32`). ``prec="fp8"`` is the control: the operands of every
product of the bf16 program (projections, experts, attention's two
products, the head) rounded to float8 e4m3 with one scale per tensor and
summed in float32, and what the program keeps in bf16 between operations
(projection outputs, the residual stream) kept in e4m3; norms, softmax,
the router and the scan stay float32, as the program keeps them. Imports
nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # e4m3's largest finite value


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


def conv_silu(x, w, b):
    """Causal depthwise convolution of x (L, C) with w (C, W), bias b, then
    SiLU; taps before the first token read zero."""
    L, W = x.shape[0], w.shape[1]
    out = b.float().expand(L, -1).clone()
    wf = w.float()
    for k in range(W):
        s = W - 1 - k  # tokens back
        if s >= L:
            continue
        out[s:] += x[: L - s] * wf[:, k]
    return F.silu(out)


def ssd_dual(x, dt, A, B, C, D):
    """The scan in its masked quadratic form: x (L, H, P), dt (L, H), A and
    D (H,), B and C (L, G, N) -> y (L, H, P)."""
    L, H, P = x.shape
    G = B.shape[1]
    hg = H // G
    cs = torch.cumsum((dt * A).double(), dim=0)          # (L, H), float64
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    for g in range(G):
        hs = slice(g * hg, (g + 1) * hg)
        seg = (cs[:, hs].t()[:, :, None] - cs[:, hs].t()[:, None, :]).float()  # (hg, L, L)
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        cb = C[:, g] @ B[:, g].t()                        # (L, L)
        xdt = (x[:, hs] * dt[:, hs, None]).transpose(0, 1)  # (hg, L, P)
        y[:, hs] = ((decay * cb) @ xdt).transpose(0, 1)
    return y + D[:, None] * x


def mamba(p, x, cfg, prec):
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    G, N = cfg["n_groups"], cfg["ssm_state_size"]
    inner = H * P
    conv = inner + 2 * G * N
    zxbcdt = _linear(x, p["in_proj"], prec)
    z, xbc, dt = zxbcdt[:, :inner], zxbcdt[:, inner:inner + conv], zxbcdt[:, inner + conv:]
    xbc = _store(conv_silu(xbc, p["conv_w"], p["conv_b"]), prec)
    L = x.shape[0]
    xs = xbc[:, :inner].reshape(L, H, P)
    B = xbc[:, inner:inner + G * N].reshape(L, G, N)
    C = xbc[:, inner + G * N:].reshape(L, G, N)
    dt = F.softplus(dt + p["dt_bias"].float())
    y = ssd_dual(xs, dt, -torch.exp(p["A_log"].float()), B, C, p["D"].float()).reshape(L, inner)
    h = y * F.silu(z)
    hg = h.view(L, G, inner // G)
    h = (hg * torch.rsqrt(hg.pow(2).mean(-1, keepdim=True) + cfg["norm_eps"])).view(L, inner)
    h = _store(h * p["gnorm"].float(), prec)
    return _linear(h, p["out_proj"], prec)


def attention(p, x, cfg, prec):
    L = x.shape[0]
    hd, Hq, Hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q = _linear(x, p["q"], prec).view(L, Hq, hd).transpose(0, 1)
    k = _linear(x, p["k"], prec).view(L, Hkv, hd).transpose(0, 1)
    v = _linear(x, p["v"], prec).view(L, Hkv, hd).transpose(0, 1)
    k = k.repeat_interleave(Hq // Hkv, dim=0)
    v = v.repeat_interleave(Hq // Hkv, dim=0)
    logits = _mm(q, k.transpose(1, 2), prec) / math.sqrt(hd)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    o = _store(_mm(probs, v, prec), prec).transpose(0, 1).reshape(L, Hq * hd)
    return _linear(o, p["o"], prec)


def relu2_mlp(x, up, down, prec):
    h = _store(torch.relu(_mm(x, up.float().t(), prec)).square(), prec)
    return _mm(h, down.float().t(), prec)


def route(p, x, cfg, chosen=None):
    """(expert ids (L, k), weights (L, k)) of the normed x: the top k by the
    biased scores, or the first rows' sets `chosen` (n, k) where given,
    gated by the unbiased scores either way."""
    scores = torch.sigmoid(x @ p["router"].float().t())
    idx = torch.topk(scores + p["router_bias"].float(), cfg["num_experts_per_tok"], dim=-1).indices
    if chosen is not None and chosen.shape[1] == idx.shape[1]:
        idx = torch.cat([chosen.to(idx.device), idx[len(chosen):]])
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(p, x, cfg, prec, routes, chosen=None):
    own, _ = route(p, x, cfg)
    routes.append(own)
    idx, w = route(p, x, cfg, chosen)
    out = torch.zeros_like(x)
    for e in range(p["up"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = relu2_mlp(x[tok], p["up"][e], p["down"][e], prec)
            out.index_add_(0, tok, y * w[tok, slot, None])
    out += relu2_mlp(x, p["shared_up"], p["shared_down"], prec)
    return _store(out, prec)


@torch.no_grad()
def forward(params, cfg: dict, ids, prec: str = "fp32", logits_from: int = 0, chosen=None):
    """ids (L,) -> (logits (L - logits_from, vocab) of the positions from
    `logits_from` on, the expert ids (L, k) each MoE layer would choose, in
    order). `chosen`, a list of (n, k) expert ids a MoE layer, forces each
    layer's choice for the first n tokens (gated by the layer's own
    scores): the reference teacher-forced on another model's routing, so
    that one near-tie decided the other way does not set the two apart
    for every layer after it."""
    h = _store(params["embed"][ids].float(), prec)
    routes = []
    eps = cfg["norm_eps"]
    for p in params["layers"]:
        x = rms_norm(h, p["norm"], eps)
        if p["kind"] == "M":
            out = mamba(p, x, cfg, prec)
        elif p["kind"] == "*":
            out = attention(p, x, cfg, prec)
        else:
            out = moe(p, x, cfg, prec, routes, None if chosen is None else chosen[len(routes)])
        h = _store(h + out, prec)
    x = rms_norm(h[logits_from:], params["norm_f"], eps)
    return _mm(x, params["lm_head"].float().t(), prec), routes
