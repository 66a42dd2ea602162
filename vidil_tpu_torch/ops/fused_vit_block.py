"""Fused pre-LN ViT block, forward and backward: the hand-written Hopper
kernels, their plain twins, the autograd Function that pairs them, and
`fused_vit_block`, the counterpart of ``vidil_tpu/ops/fused_vit_block.py``.

One block computes

    y   = x + proj(MHA(LN1 x))
    out = y + fc2(GELU(fc1(LN2 y)))

on a token axis padded to a multiple of 128: keys at positions >=
``true_len`` are masked with a -1e30 score bias (only when the axis is
padded); pad rows are computed like any other row (finite garbage the
caller slices off).

On CUDA tensors the forward launches ``csrc/fused_vit_block_fwd.cu`` (the
counterpart of the TPU kernel ``_fused_block_forward``, K4) and the
backward ``csrc/fused_vit_block_bwd.cu`` (the counterpart of
``_fused_block_backward``, K5): each is one C call per layer that runs a
short chain of kernel launches on the current stream. On CPU tensors the
same Function runs the plain twins, `fused_block_ref` and
`fused_block_bwd_ref`, which keep the TPU kernels' rounding points. The
block's attention and K5's attention backward also launch alone
(`_launch_attention`, `_launch_attention_bwd`), against their twins
`block_attention_ref` and `block_attention_bwd_ref`. Nothing falls back: a
CUDA launch that cannot run raises.

Rounding points of the forward (``_block_kernel``): LN statistics in fp32,
its output rounded to the input dtype; each GEMM accumulates in fp32, adds
its bias in fp32 and is rounded; q is not pre-scaled, the fp32 scores are
multiplied by 1/√Dh, p = e / Σe is normalised in fp32 and then rounded
before p·v; each head's output is rounded; the fc1 output is rounded, GELU
runs in fp32 on the rounded value and is rounded again. GELU uses the
exact erf (``torch.erf`` here, ``erff`` in CUDA); the TPU kernel uses an
A&S approximation of erf (max error 1.5e-7), which the CPU tests' fp32
tolerance (5e-5) covers. Backward rounding points: see
`fused_block_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

NEG_INF = -1e30
KERNEL_HEAD_DIM = 64

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# launches of the CUDA kernels by this process, one per layer call (or, for
# fused_vit_block_attention and fused_vit_block_attention_bwd, per call of
# the block's attention or attention backward alone), for showing that a run
# went through them; `reset_launch_counts` sets them to 0
launch_counts = {"fused_vit_block_fwd": 0, "fused_vit_block_bwd": 0,
                 "fused_vit_block_attention": 0, "fused_vit_block_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _acc_dtype(dtype):
    """fp32 accumulation for bf16/fp32 inputs (the kernels'); fp64 inputs
    stay fp64, so that the twins can be checked against autograd in fp64."""
    return torch.promote_types(dtype, torch.float32)


def _gelu_exact_f32(h):
    """GELU with the exact erf, in the dtype of `h` (fp32 in the kernels)."""
    return 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))


def _dgelu_exact_f32(h):
    """d/dh gelu(h) = Phi(h) + h * phi(h)."""
    phi = torch.exp(-0.5 * h * h) * 0.3989422804014327  # N(0,1) pdf
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * phi


# ---------------------------------------------------------------------------
# plain twins of the kernels
# ---------------------------------------------------------------------------

def _ln_stats(x32, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    return (x32 - mean) * r, r


def _ln_bwd(dh, xhat, r, s):
    """d/dx of xhat(x) * s + b given the upstream dh (all in acc)."""
    dxhat = dh * s
    return r * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))


def _heads(t, num_heads):
    """(B, L, H*Dh) -> (B, H, L, Dh)"""
    B, L, D = t.shape
    return t.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _merge(t):
    """(B, H, L, Dh) -> (B, L, H*Dh)"""
    B, H, L, Dh = t.shape
    return t.transpose(1, 2).reshape(B, L, H * Dh)


def _key_bias(Lp, true_len, acc, device):
    if Lp == true_len:
        return None
    pos = torch.arange(Lp, device=device)
    return torch.where(pos < true_len, 0.0, NEG_INF).to(acc)


def _dense(a, w, b, acc):
    """a @ w + b with the product and the bias add in `acc`."""
    return torch.matmul(a.to(acc), w.to(acc)) + b.to(acc)


def _attention(qkv, true_len, num_heads):
    """The block's attention on its (B, Lp, 3D) QKV output, at the kernels'
    rounding points: q, k, v (B, H, Lp, Dh), the fp32 probabilities, the
    merged-head output (B, Lp, D) and the softmax statistics, row max and
    row sum of e = exp(s - max), (B, H, Lp)."""
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    B, Lp, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (1.0 / math.sqrt(D // num_heads))
    bias = _key_bias(Lp, true_len, acc, qkv.device)
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p32 = e / l
    attn = _merge(torch.matmul(p32.to(dt).to(acc), v.to(acc)).to(dt))
    return dict(q=q, k=k, v=v, p32=p32, attn=attn, row_max=m[..., 0], row_sum=l[..., 0])


def block_attention_ref(qkv, *, true_len: int, num_heads: int, with_stats: bool = False):
    """Plain PyTorch version of the block's attention launch: qkv (B, Lp,
    3D) -> (B, Lp, D) in qkv's dtype, and with `with_stats` the row max and
    row sum, (B*H, Lp) in the accumulation dtype (fp32 for bf16/fp32)."""
    f = _attention(qkv, true_len, num_heads)
    if not with_stats:
        return f["attn"]
    B, H, Lp = f["row_max"].shape
    return f["attn"], f["row_max"].reshape(B * H, Lp), f["row_sum"].reshape(B * H, Lp)


def _attention_bwd(p32, q, k, v, do, scale, dt):
    """K5's attention backward per head at its rounding points, from the
    fp32 probabilities p32 (B, H, Lp, Lp) and q, k, v, do (B, H, Lp, Dh):
    the fp32 dq, dk, dv merged into (B, Lp, 3D), unrounded, and D (B, H,
    Lp)."""
    acc = p32.dtype
    dv = torch.matmul(p32.to(dt).to(acc).transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    delta = (dp * p32).sum(dim=-1, keepdim=True)
    dsb = (p32 * (dp - delta) * scale).to(dt).to(acc)
    dq = torch.matmul(dsb, k.to(acc))
    dk = torch.matmul(dsb.transpose(-1, -2), q.to(acc))
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1), delta[..., 0]


def block_attention_bwd_ref(qkv, do, row_max, row_sum, *, true_len: int, num_heads: int):
    """Plain PyTorch version of K5's attention backward launch alone (its
    dq and dk/dv passes, with dbqkv): qkv (B, Lp, 3D) and the rounded
    output gradient do (B, Lp, D) in one dtype, the recompute's row max and
    row sum (B*H, Lp) -> (dqkv (B, Lp, 3D), D (B*H, Lp), dbqkv (3D,)), all
    in the accumulation dtype and unrounded. p32 = exp(s - m) / l is
    rebuilt from the statistics (s the scaled scores, -1e30 past
    true_len); D = sum_k dp * p32; dsb = round(p32 (dp - D) scale);
    dv = round(p32)^T do, dq = dsb k, dk = dsb^T q with q unscaled;
    dbqkv = colsum(dqkv)."""
    dt, acc = qkv.dtype, _acc_dtype(qkv.dtype)
    B, Lp, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    scale = 1.0 / math.sqrt(D // num_heads)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    bias = _key_bias(Lp, true_len, acc, qkv.device)
    if bias is not None:
        s = s + bias
    stat = lambda t: t.reshape(B, num_heads, Lp, 1).to(acc)  # noqa: E731
    p32 = torch.exp(s - stat(row_max)) / stat(row_sum)
    dqkv, delta = _attention_bwd(p32, q, k, v, _heads(do, num_heads), scale, dt)
    return dqkv, delta.reshape(B * num_heads, Lp), dqkv.reshape(-1, D3).sum(dim=0)


def _recompute(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1,
               *, true_len, num_heads, eps):
    """The block's forward up to the GELU, at the kernels' rounding points;
    returns every intermediate the backward reads."""
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    scale = 1.0 / math.sqrt(x.shape[-1] // num_heads)
    xhat1, r1 = _ln_stats(x.to(acc), eps)
    h1 = (xhat1 * ln1s.to(acc) + ln1b.to(acc)).to(dt)
    qkv = _dense(h1, wqkv, bqkv, acc).to(dt)
    at = _attention(qkv, true_len, num_heads)
    y = x + _dense(at["attn"], wproj, bproj, acc).to(dt)
    xhat2, r2 = _ln_stats(y.to(acc), eps)
    h2 = (xhat2 * ln2s.to(acc) + ln2b.to(acc)).to(dt)
    hh = _dense(h2, w1, b1, acc).to(dt)
    a = _gelu_exact_f32(hh.to(acc)).to(dt)
    return dict(xhat1=xhat1, r1=r1, h1=h1, q=at["q"], k=at["k"], v=at["v"], p32=at["p32"],
                attn=at["attn"], y=y, xhat2=xhat2, r2=r2, h2=h2, hh=hh, a=a, scale=scale)


def fused_block_ref(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2,
                    *, true_len: int, num_heads: int, eps: float):
    """Plain PyTorch version of the forward kernel (the TPU kernel's
    ``_block_kernel``): x (B, Lp, D) -> (B, Lp, D) in x's dtype. Linear
    weights and biases come in x's dtype, LayerNorm parameters in any."""
    f = _recompute(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1,
                   true_len=true_len, num_heads=num_heads, eps=eps)
    acc = _acc_dtype(x.dtype)
    return f["y"] + _dense(f["a"], w2, b2, acc).to(x.dtype)


def fused_block_bwd_ref(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2,
                        g, *, true_len: int, num_heads: int, eps: float):
    """Plain PyTorch version of the backward kernel (``_block_bwd_kernel``):
    recompute the forward from x, then reverse mode by hand. Returns (dx in
    x's dtype, then the 12 parameter gradients in the accumulation dtype,
    summed over every row: dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2s,
    dln2b, dw1, db1, dw2, db2). Rounding points, step by step:

        db2 = colsum(g);  dw2 = aᵀ·g;  da = g·w2ᵀ (fp32)
        dhh32 = da · GELU′(hh);  db1 = colsum(dhh32), unrounded
        dw1 = h2ᵀ·round(dhh);  dh2 = round(dhh)·w1ᵀ (fp32)
        dln2s = colsum(dh2 · x̂2);  dln2b = colsum(dh2)
        dy = g + LN2 backward (fp32);  dbproj = colsum(dy)
        dwproj = attnᵀ·round(dy);  do = round(round(dy)·wprojᵀ)
        per head, p32 recomputed:  dv = round(p32)ᵀ·do;  dp = do·vᵀ (fp32)
            D = Σ_k dp·p32;  ds = p32·(dp − D);  dsb = round(ds·scale)
            dq = dsb·k,  dk = dsbᵀ·q  (q unscaled; both stay fp32)
        dbqkv = colsum(dqkv32), unrounded;  dwqkv = h1ᵀ·round(dqkv32)
        dh1 = round(dqkv32)·wqkvᵀ;  dln1s, dln1b as for LN2
        dx = round(dy + LN1 backward)
    """
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    f = _recompute(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1,
                   true_len=true_len, num_heads=num_heads, eps=eps)

    def rows(t):
        return t.reshape(-1, t.shape[-1]).to(acc)

    def colsum(t):
        return rows(t).sum(dim=0)

    def tn(a, b):  # aᵀ·b summed over every row
        return rows(a).t() @ rows(b)

    def nt(a, w):  # a·wᵀ
        return torch.matmul(a.to(acc), w.to(acc).t())

    g32 = g.to(acc)
    gb = g32.to(dt)
    db2 = colsum(g32)
    dw2 = tn(f["a"], gb)
    dhh32 = nt(gb, w2) * _dgelu_exact_f32(f["hh"].to(acc))
    dhh = dhh32.to(dt)
    db1 = colsum(dhh32)
    dw1 = tn(f["h2"], dhh)
    dh2 = nt(dhh, w1)
    dln2s = colsum(dh2 * f["xhat2"])
    dln2b = colsum(dh2)
    dy = g32 + _ln_bwd(dh2, f["xhat2"], f["r2"], ln2s.to(acc))
    dyb = dy.to(dt)
    dbproj = colsum(dy)
    dwproj = tn(f["attn"], dyb)
    do = _heads(nt(dyb, wproj).to(dt), num_heads)

    dqkv32, _ = _attention_bwd(f["p32"], f["q"], f["k"], f["v"], do, f["scale"], dt)
    dqkvb = dqkv32.to(dt)
    dbqkv = colsum(dqkv32)
    dwqkv = tn(f["h1"], dqkvb)
    dh1 = nt(dqkvb, wqkv)
    dln1s = colsum(dh1 * f["xhat1"])
    dln1b = colsum(dh1)
    dx = (dy + _ln_bwd(dh1, f["xhat1"], f["r1"], ln1s.to(acc))).to(dt)
    return (dx, dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2s, dln2b, dw1, db1, dw2, db2)


def block_ref(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2,
              *, true_len: int, num_heads: int, eps: float):
    """The block as plain framework ops, differentiable by autograd: the
    counterpart of the TPU package's ``_block_ref_xla``, which is its
    recompute backward when the backward kernel is off. Each linear is a
    product in the input dtype plus a bias add in it; the attention logits
    and softmax are in the accumulation dtype."""
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    B, Lp, D = x.shape

    def ln(x_, s, b):
        xhat, _ = _ln_stats(x_.to(acc), eps)
        return (xhat * s.to(acc) + b.to(acc)).to(dt)

    h1 = ln(x, ln1s, ln1b)
    qkv = (torch.matmul(h1, wqkv) + bqkv).to(dt)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(D, dim=-1))
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) / math.sqrt(D // num_heads)
    bias = _key_bias(Lp, true_len, acc, x.device)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    o = _merge(torch.matmul(probs.to(dt), v))
    y = x + (torch.matmul(o, wproj) + bproj).to(dt)
    h2 = ln(y, ln2s, ln2b)
    hh = (torch.matmul(h2, w1) + b1).to(dt)
    a = F.gelu(hh, approximate="none")
    return y + (torch.matmul(a, w2) + b2).to(dt)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _check_kernel_operands(x, ln, lin, true_len, num_heads):
    """The kernels take bf16/fp32, contiguous operands, head dim 64, D and
    the MLP width multiples of 128, a token axis padded to a multiple of
    128, and fp32 LayerNorm parameters."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_vit_block kernel takes bf16 or fp32, got {x.dtype}")
    B, Lp, D = x.shape
    if D % num_heads or D // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"fused_vit_block kernel takes head dim {KERNEL_HEAD_DIM}, "
                         f"got D={D} over {num_heads} heads")
    Dm = lin[4].shape[1]
    if D % 128 or Dm % 128 or Lp % 128:
        raise ValueError(f"fused_vit_block kernel wants D, the MLP width and the token axis "
                         f"in multiples of 128, got D={D}, Dm={Dm}, Lp={Lp}")
    if not 0 < true_len <= Lp:
        raise ValueError(f"true_len {true_len} outside (0, {Lp}]")
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D, Dm), (Dm,), (Dm, D), (D,))
    for t, want in zip(lin, shapes):
        if tuple(t.shape) != want or t.dtype != x.dtype:
            raise ValueError(f"fused_vit_block: weight {tuple(t.shape)} {t.dtype}, "
                             f"want {want} {x.dtype}")
    for t in (x, *ln, *lin):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fused_vit_block: operands must be contiguous, on one device")
    for t in ln:
        if t.dtype != torch.float32 or tuple(t.shape) != (D,):
            raise ValueError("fused_vit_block: LayerNorm parameters must be fp32 (D,)")
    if any(t.data_ptr() % 16 for t in (x, *lin)):
        raise ValueError("fused_vit_block: x and the linears' weights and biases must be "
                         "16-byte aligned (the GEMM's tensor maps and vector loads)")
    return B, Lp, D, Dm


def _split(args):
    """(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2)
    -> x, LN params as contiguous fp32, linear params contiguous."""
    x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2 = args
    ln = tuple(t.float().contiguous() for t in (ln1s, ln1b, ln2s, ln2b))
    lin = tuple(t.contiguous() for t in (wqkv, bqkv, wproj, bproj, w1, b1, w2, b2))
    return x.contiguous(), ln, lin


def _operand_ptrs(ln, lin):
    ln1s, ln1b, ln2s, ln2b = ln
    wqkv, bqkv, wproj, bproj, w1, b1, w2, b2 = lin
    return [t.data_ptr() for t in (ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b,
                                   w1, b1, w2, b2)]


def _launch_fwd(args, true_len, num_heads, eps):
    """Run the forward kernel chain on CUDA tensors: (B, Lp, D) out."""
    x, ln, lin = _split(args)
    B, Lp, D, Dm = _check_kernel_operands(x, ln, lin, true_len, num_heads)
    fns = _kernel_fns()
    code = _DTYPE_CODE[x.dtype]
    ws = torch.empty(fns["fwd_ws"](code, B, Lp, D, Dm, num_heads), dtype=torch.uint8,
                     device=x.device)
    out = torch.empty_like(x)
    err = fns["fwd"](x.data_ptr(), *_operand_ptrs(ln, lin), out.data_ptr(), ws.data_ptr(),
                     code, x.device.index, B, Lp, D, Dm, num_heads, true_len, eps,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_vit_block_fwd launch failed: cudaError {err}")
    launch_counts["fused_vit_block_fwd"] += 1
    return out


def _launch_bwd(args, g, true_len, num_heads, eps):
    """Run the backward kernel chain on CUDA tensors: (dx, then the 12
    parameter gradients in fp32)."""
    x, ln, lin = _split(args)
    B, Lp, D, Dm = _check_kernel_operands(x, ln, lin, true_len, num_heads)
    g = g.to(x.dtype).contiguous()
    if g.shape != x.shape or g.data_ptr() % 16:
        raise ValueError(f"fused_vit_block: gradient {tuple(g.shape)} for x {tuple(x.shape)}, "
                         "16-byte aligned")
    fns = _kernel_fns()
    code = _DTYPE_CODE[x.dtype]
    ws = torch.empty(fns["bwd_ws"](code, B, Lp, D, Dm, num_heads), dtype=torch.uint8,
                     device=x.device)
    dx = torch.empty_like(x)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)
    grads = (f32(D), f32(D), f32(D, 3 * D), f32(3 * D), f32(D, D), f32(D),
             f32(D), f32(D), f32(D, Dm), f32(Dm), f32(Dm, D), f32(D))
    err = fns["bwd"](x.data_ptr(), *_operand_ptrs(ln, lin), g.data_ptr(), dx.data_ptr(),
                     *[t.data_ptr() for t in grads], ws.data_ptr(),
                     code, x.device.index, B, Lp, D, Dm, num_heads, true_len, eps,
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_vit_block_bwd launch failed: cudaError {err}")
    launch_counts["fused_vit_block_bwd"] += 1
    return (dx,) + grads


def _attn_args(qkv, out, row_max, row_sum, true_len, num_heads, stream):
    """The attention C entry's arguments, in its order (row_max and row_sum
    None: no statistics)."""
    B, Lp, D3 = qkv.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    return (qkv.data_ptr(), out.data_ptr(), ptr(row_max), ptr(row_sum), _DTYPE_CODE[qkv.dtype],
            qkv.device.index, B, Lp, D3 // 3, num_heads, true_len, stream)


def _check_attention_operands(qkv, true_len, num_heads):
    """The attention launches take a bf16/fp32 (B, Lp, 3D) QKV workspace
    with head dim 64, D and the token axis multiples of 128 and
    0 < true_len <= Lp: (B, Lp, D)."""
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_vit_block attention takes bf16 or fp32, got {qkv.dtype}")
    B, Lp, D3 = qkv.shape
    D = D3 // 3
    if D3 % 3 or D % num_heads or D // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"fused_vit_block attention takes head dim {KERNEL_HEAD_DIM}, "
                         f"got {D3} = 3 x {D} over {num_heads} heads")
    if D % 128 or Lp % 128 or not 0 < true_len <= Lp:
        raise ValueError(f"fused_vit_block attention wants D and the token axis in multiples "
                         f"of 128 and 0 < true_len <= Lp, got D={D}, Lp={Lp}, true_len={true_len}")
    return B, Lp, D


def _launch_attention(qkv, true_len, num_heads, with_stats=False):
    """Run the block's attention launch alone on a CUDA (B, Lp, 3D) QKV
    workspace: (B, Lp, D) out, and with `with_stats` the (B*H, Lp) fp32 row
    max and row sum that the backward's recompute keeps."""
    B, Lp, D = _check_attention_operands(qkv, true_len, num_heads)
    qkv = qkv.contiguous()
    out = torch.empty((B, Lp, D), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((2, B * num_heads, Lp), dtype=torch.float32, device=qkv.device)
             if with_stats else (None, None))
    err = _kernel_fns()["attention"](*_attn_args(
        qkv, out, stats[0], stats[1], true_len, num_heads,
        torch.cuda.current_stream(qkv.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fused_vit_block_attention launch failed: cudaError {err}")
    launch_counts["fused_vit_block_attention"] += 1
    return (out, stats[0], stats[1]) if with_stats else out


def _attn_bwd_args(qkv, do, row_max, row_sum, stats, dqkv, part, dbqkv, true_len, num_heads,
                   stream):
    """The attention backward C entry's arguments, in its order."""
    B, Lp, D3 = qkv.shape
    return (qkv.data_ptr(), do.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
            stats.data_ptr(), dqkv.data_ptr(), part.data_ptr(), dbqkv.data_ptr(),
            _DTYPE_CODE[qkv.dtype], qkv.device.index, B, Lp, D3 // 3, num_heads, true_len, stream)


def _launch_attention_bwd(qkv, do, row_max, row_sum, true_len, num_heads):
    """Run K5's attention backward alone (its dq and dk/dv passes, with
    dbqkv) on a CUDA (B, Lp, 3D) QKV workspace, the rounded (B, Lp, D)
    output gradient and the recompute's (B*H, Lp) fp32 row max and row sum:
    (dqkv (B, Lp, 3D) rounded to qkv's dtype, D (B*H, Lp) fp32, dbqkv (3D,)
    fp32)."""
    B, Lp, D = _check_attention_operands(qkv, true_len, num_heads)
    H, D3 = num_heads, 3 * D
    if do.shape != (B, Lp, D) or do.dtype != qkv.dtype:
        raise ValueError(f"fused_vit_block attention backward: do {tuple(do.shape)} {do.dtype}, "
                         f"want {(B, Lp, D)} {qkv.dtype}")
    stats_in = []
    for t in (row_max, row_sum):
        if t.shape != (B * H, Lp) or t.dtype != torch.float32:
            raise ValueError(f"fused_vit_block attention backward: statistics "
                             f"{tuple(t.shape)} {t.dtype}, want {(B * H, Lp)} fp32")
        stats_in.append(t.contiguous())
    qkv, do = qkv.contiguous(), do.contiguous()
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=qkv.device)  # noqa: E731
    stats, part, dbqkv = f32(B * H, Lp // 64, 4, 64), f32(B * Lp // 64, D3), f32(D3)
    dqkv = torch.empty_like(qkv)
    err = _kernel_fns()["attention_bwd"](*_attn_bwd_args(
        qkv, do, *stats_in, stats, dqkv, part, dbqkv, true_len, H,
        torch.cuda.current_stream(qkv.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fused_vit_block_attention_bwd launch failed: cudaError {err}")
    launch_counts["fused_vit_block_attention_bwd"] += 1
    return dqkv, stats[:, :, 3].reshape(B * H, Lp), dbqkv


_fns: dict = {}


def _kernel_fns():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        _build.build_all(["fused_vit_block_fwd", "fused_vit_block_bwd"])  # nvcc in parallel
        fwd_lib = _build.load("fused_vit_block_fwd")
        bwd_lib = _build.load("fused_vit_block_bwd")
        dims = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fwd = fwd_lib.vidil_fused_block_fwd
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 15 + dims
        bwd = bwd_lib.vidil_fused_block_bwd
        bwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 28 + dims
        fwd_ws = fwd_lib.vidil_fused_block_fwd_workspace
        bwd_ws = bwd_lib.vidil_fused_block_bwd_workspace
        for fn in (fwd_ws, bwd_ws):
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int] * 6
        attention = fwd_lib.vidil_fused_block_attention
        attention.restype = ctypes.c_int
        attention.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        attention_bwd = bwd_lib.vidil_fused_block_attention_bwd
        attention_bwd.restype = ctypes.c_int
        attention_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        splits = bwd_lib.vidil_fused_block_bwd_wgrad_splits
        splits.restype = ctypes.c_int
        splits.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        _fns.update(fwd=fwd, bwd=bwd, fwd_ws=fwd_ws, bwd_ws=bwd_ws, wgrad_splits=splits,
                    attention=attention, attention_bwd=attention_bwd)
    return _fns


def weight_grad_splits(dtype, B, Lp, D, Dm, num_heads):
    """How many split-K partials the backward kernel sums for each of its
    weight gradients (dw2, dw1, dwproj, dwqkv) at these dimensions: the
    kernel's own tile plan (csrc/gemm_sm90.cuh:plan for bf16)."""
    out = (ctypes.c_int * 4)()
    if _kernel_fns()["wgrad_splits"](_DTYPE_CODE[dtype], B, Lp, D, Dm, num_heads, out) != 0:
        raise ValueError(f"fused_vit_block_bwd takes no ({B}, {Lp}, {D}, {Dm}, {num_heads})")
    return tuple(out)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _forward(args, true_len, num_heads, eps):
    x = args[0]
    if x.is_cuda:
        return _launch_fwd(args, true_len, num_heads, eps)
    if x.device.type == "cpu":
        return fused_block_ref(*args, true_len=true_len, num_heads=num_heads, eps=eps)
    raise RuntimeError(f"fused_vit_block: no kernel for device {x.device}")


def _backward(args, g, true_len, num_heads, eps):
    """dx and the 12 parameter gradients, each cast to its input's dtype
    (the linears' bf16 weights get bf16 gradients, as in the TPU package)."""
    x = args[0]
    if x.is_cuda:
        grads = _launch_bwd(args, g, true_len, num_heads, eps)
    else:
        grads = fused_block_bwd_ref(*args, g.to(x.dtype), true_len=true_len,
                                    num_heads=num_heads, eps=eps)
    return tuple(d.to(a.dtype) for d, a in zip(grads, args))


class FusedBlockFunction(torch.autograd.Function):
    """Differentiable fused block: the forward kernel, and for the gradient
    either the backward kernel (``pallas_bwd``, which recomputes the block
    from x: only x is saved per layer) or autograd through a recompute of
    `block_ref` (the TPU package's ``pallas_bwd=False`` branch). On CPU
    tensors the kernels are the twins."""

    @staticmethod
    def forward(ctx, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2,
                true_len: int, num_heads: int, eps: float, pallas_bwd: bool):
        args = (x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        ctx.block = (true_len, num_heads, eps, pallas_bwd)
        return _forward(args, true_len, num_heads, eps)

    @staticmethod
    @once_differentiable  # K5 records no graph: a double backward raises on every device
    def backward(ctx, g):
        args = ctx.saved_tensors
        true_len, num_heads, eps, pallas_bwd = ctx.block
        if pallas_bwd:
            grads = _backward(args, g, true_len, num_heads, eps)
        else:
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(True) for a in args]
                out = block_ref(*leaves, true_len=true_len, num_heads=num_heads, eps=eps)
                grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def fused_vit_block(params, x, num_heads: int, eps: float, true_len: int,
                    frames_per_program: int = 1, pallas_bwd: bool = False,
                    bwd_frames: int = 1):
    """One pre-LN ViT block (the ``models/vit.py`` block pytree) over
    x (B, Lp, D), Lp a multiple of 128, rows at or past `true_len` padding.
    The linears' weights and biases are cast to x's dtype, the LayerNorm
    parameters are used as they are (in fp32), as in the TPU package.

    `pallas_bwd` selects the backward kernel instead of autograd through
    `block_ref`. `frames_per_program` and `bwd_frames` are the TPU grid's
    frames per program; the Hopper kernels choose their own tiling and
    their results do not depend on them (the arguments are accepted for
    the configs' sake)."""
    del frames_per_program, bwd_frames
    dt = x.dtype
    a, m = params["attn"], params["mlp"]
    return FusedBlockFunction.apply(
        x, params["norm1"]["scale"], params["norm1"]["bias"],
        a["qkv"]["kernel"].to(dt), a["qkv"]["bias"].to(dt),
        a["proj"]["kernel"].to(dt), a["proj"]["bias"].to(dt),
        params["norm2"]["scale"], params["norm2"]["bias"],
        m["fc1"]["kernel"].to(dt), m["fc1"]["bias"].to(dt),
        m["fc2"]["kernel"].to(dt), m["fc2"]["bias"].to(dt),
        true_len, num_heads, eps, pallas_bwd)
