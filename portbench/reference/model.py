"""Plain BLIP in PyTorch: the ViT image encoder (pre-LN), the MED text
transformer (post-LN BERT with cross-attention), its LM head and the ITM
head, written from the BLIP paper and its released ``med_config.json``.

Parameters are nested dicts with (in, out) linear kernels, the layout
`portbench/weights.py` draws. Every op runs in float32 with TF32 off
(`exact_fp32`). ``prec="fp8"`` is the control, the model computed in
float8 where a bf16 program computes in bf16: the operands of every
product (linears, the attention's two, the LM head's) rounded to float8
e4m3 with one scale per tensor and summed in float32, the output gradient
of each product in e5m2, and what lies between operations (linear and
attention outputs, the residual stream) kept in e4m3; LayerNorm and
softmax stay float32, as the program keeps them. Imports nothing of the
program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NEG = -10000.0  # BERT's additive mask value
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite


def exact_fp32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t, dtype=torch.float8_e4m3fn):
    """`t` through a float8 type and back, one absmax scale for the tensor."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX[dtype]
    return (t / s).to(dtype).float() * s


class _Fp8Matmul(torch.autograd.Function):
    """a @ b on float8 operands with float32 sums, the usual float8
    recipe: e4m3 for the forward's operands, e5m2 for the output
    gradient, one scale per tensor."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8_round(a.detach()), fp8_round(b.detach())
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8_round(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), (a8.transpose(-1, -2) @ g8).sum_to_size(b8.shape)


class _Fp8Store(torch.autograd.Function):
    """A tensor kept in float8 e4m3 (one scale), the gradient passed on."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, prec):
    return _Fp8Matmul.apply(a, b) if prec == "fp8" else a @ b


def _store(x, prec):
    """`x` as the computation keeps it between operations: as it is in
    float32, rounded to float8 in the control, where a bf16 program keeps
    bf16 (linear outputs, the residual stream)."""
    return _Fp8Store.apply(x) if prec == "fp8" else x


def linear(p, x, prec="fp32"):
    return _store(_mm(x, p["kernel"], prec) + p["bias"], prec)


def layer_norm(p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def gelu(x):
    return F.gelu(x)


def _heads(x, h):
    B, L, D = x.shape
    return x.reshape(B, L, h, D // h).transpose(1, 2)


def _merge(x):
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)


def _softmax_attend(q, k, v, bias=None, prec="fp32"):
    logits = _mm(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    return _store(_mm(torch.softmax(logits, dim=-1), v, prec), prec)


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------

def normalize_uint8(frames):
    """uint8 (N, S, S, 3) -> float32 CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, device=frames.device)
    std = torch.tensor(CLIP_STD, device=frames.device)
    return (frames.float() / 255.0 - mean) / std


def vit(p, images, cfg, prec="fp32"):
    """images (N, S, S, 3) normalized -> (N, 1 + (S/P)^2, D): patches in
    (row, column, channel) order through one linear, [CLS], learned
    positions, pre-LN blocks with exact GELU, a final LayerNorm."""
    N, S, _, C = images.shape
    P, D, h, eps = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"], cfg["layer_norm_eps"]
    n = S // P
    x = images.reshape(N, n, P, n, P, C).permute(0, 1, 3, 2, 4, 5).reshape(N, n * n, P * P * C)
    x = linear(p["patch_embed"], x, prec)
    x = torch.cat([p["cls_token"].expand(N, 1, D), x], dim=1)
    x = x + p["pos_embed"][:, : x.shape[1]]
    for blk in p["blocks"]:
        y = layer_norm(blk["norm1"], x, eps)
        q, k, v = (_heads(t, h) for t in linear(blk["attn"]["qkv"], y, prec).chunk(3, dim=-1))
        x = _store(x + linear(blk["attn"]["proj"], _merge(_softmax_attend(q, k, v, prec=prec)),
                              prec), prec)
        y = layer_norm(blk["norm2"], x, eps)
        x = _store(x + linear(blk["mlp"]["fc2"], gelu(linear(blk["mlp"]["fc1"], y, prec)), prec),
                   prec)
    return layer_norm(p["norm"], x, eps)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def _attention_block(p, x, mem, bias, h, eps, prec, group=1):
    """Post-LN attention: queries from x, keys and values from `mem`
    (x itself for self-attention). With `group` > 1, x holds group rows
    per row of `mem`, and each group attends its one memory row."""
    q = _heads(linear(p["query"], x, prec), h)
    k = _heads(linear(p["key"], mem, prec), h)
    v = _heads(linear(p["value"], mem, prec), h)
    if group > 1:
        Bg, H, L, Dh = q.shape
        q = q.reshape(Bg // group, group, H, L, Dh).transpose(1, 2).reshape(Bg // group, H,
                                                                           group * L, Dh)
        ctx = _softmax_attend(q, k, v, prec=prec)
        ctx = ctx.reshape(Bg // group, H, group, L, Dh).transpose(1, 2).reshape(Bg, H, L, Dh)
    else:
        ctx = _softmax_attend(q, k, v, bias, prec)
    return _store(layer_norm(p["norm"], linear(p["out"], _merge(ctx), prec) + x, eps), prec)


def med(p, ids, mask, memory, cfg, prec="fp32", causal=False, group=1):
    """BERT text transformer -> last hidden state (B, L, D). `memory`
    (B / group, Lk, W), attended in full by every layer's cross-attention,
    or None for text alone."""
    B, L = ids.shape
    h, eps = cfg["num_heads"], cfg["layer_norm_eps"]
    x = p["embeddings"]["word"]["embedding"][ids]
    x = x + p["embeddings"]["position"]["embedding"][torch.arange(L, device=ids.device)]
    x = layer_norm(p["embeddings"]["norm"], x, eps)
    keep = mask[:, None, None, :].float()
    if causal:
        keep = keep * torch.tril(torch.ones(L, L, device=ids.device))[None, None]
    bias = (1.0 - keep) * NEG
    for layer in p["layers"]:
        x = _attention_block(layer["self_attn"], x, x, bias, h, eps, prec)
        if memory is not None:
            x = _attention_block(layer["cross_attn"], x, memory, None, h, eps, prec, group)
        y = linear(layer["mlp"]["fc2"], gelu(linear(layer["mlp"]["fc1"], x, prec)), prec)
        x = _store(layer_norm(layer["mlp_norm"], y + x, eps), prec)
    return x


def lm_logits(p, hidden, cfg, prec="fp32"):
    """The tied LM head: dense, GELU, LayerNorm, then the word embedding's
    transpose and the output bias."""
    t = p["cls"]["transform"]
    y = layer_norm(t["norm"], gelu(linear(t["dense"], hidden, prec)), cfg["layer_norm_eps"])
    return _mm(y, p["embeddings"]["word"]["embedding"].t(), prec) + p["cls"]["bias"]


def itm_probs(p, ids, mask, memory, cfg, prec="fp32", group=1):
    """P(match) of each text row against its memory row: softmax over the
    ITM head's two logits at [CLS], index 1."""
    x = med(p["text_encoder"], ids, mask, memory, cfg, prec, group=group)
    return torch.softmax(linear(p["itm_head"], x[:, 0], prec), dim=-1)[:, 1]


def caption_loss(p, embeds, ids, mask, prompt_length, cfg, prec="fp32", count=None):
    """BLIP's captioning loss: next-token cross entropy with label
    smoothing over the caption's tokens (the prompt's and the pads'
    targets ignored). Returns (sum over this batch's targets, their count);
    the mean is the sum over `count` targets when `count` is given."""
    x = med(p["text_decoder"], ids, mask, embeds, cfg, prec, causal=True)
    logp = torch.log_softmax(lm_logits(p["text_decoder"], x, cfg, prec)[:, :-1], dim=-1)
    target = ids[:, 1:]
    pos = torch.arange(1, ids.shape[1], device=ids.device)[None]
    valid = (mask[:, 1:] == 1) & (pos >= prompt_length)
    eps = cfg["label_smoothing"]
    nll = -logp.gather(-1, target[..., None])[..., 0]
    per = (1.0 - eps) * nll - eps * logp.mean(dim=-1)
    total = torch.where(valid, per, torch.zeros_like(per)).sum()
    n = valid.sum()
    return total / (n if count is None else count), n
