"""Kimi Delta Attention (KDA), the gated delta rule of Kimi Linear's linear
layers, over packed prompts and one decode token: the per-channel decay
gate, the chunked rule, the one-token update and the gated output norm.

The JAX package has no linear-attention layer, so nothing here replaces a
TPU kernel (`models/kimi_linear.py` calls it). Everything is plain PyTorch.

The rule, per head, with a state S (dk, dv) that is zero at each prompt's
start, the keys and queries L2-normalised and a decay alpha_t = exp(g_t)
per key channel (g <= 0):

    S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T
    o_t = dk^-1/2 S_t^T q_t

The chunked form (the WY representation of Yang et al. 2024's DeltaNet,
with Kimi Linear's per-channel decay). Inside a chunk of C tokens, G_i is
the sum of g over the chunk's tokens up to i and S_0 the state entering
the chunk. With u_j = beta_j (v_j - S'_j^T k_j), S'_j the decayed state
before token j's write,

    (I + A) U = beta (V - (K * e^G) S_0),  A_jm = beta_j sum_c k_jc k_mc e^(G_jc - G_mc), m < j
    O = (Q * e^G) S_0 + P U,               P_im = sum_c q_ic k_mc e^(G_ic - G_mc),      m <= i
    S_C = e^(G_C) S_0 + (K * e^(G_C - G))^T U

so the unit lower-triangular solve gives W = (I + A)^-1 beta (K * e^G) and
U~ = (I + A)^-1 beta V once for every chunk in parallel, and the pass
across chunks is U = U~ - W S_0, then O and S_C: a few batched products a
step. Every exponent is a sum of g over an interval of tokens, so it is
never positive: A and P take a pair of a chunk's tokens through a point
between them (e^(G_j - G_m) = e^(G_j - G_r) e^(G_r - G_m), both factors
at most one), the chunk halved level by level (`_decay_grams`). Whatever
the gate gives, nothing overflows; a decay too strong for float32
underflows to the zero it stands for.

Packing as `ops/ssd.py`'s: each prompt in its own chunks of the layout
(`ssd.chunk_layout`), padding slots zero, so that they neither decay nor
add. Sums in float32 over the compute dtype's q, k and v; the states are
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

L2_EPS = 1e-6


def gate(a, A_log, dt_bias):
    """The decay's logarithm g = -exp(A_log) softplus(a + dt_bias): a (T,
    H*dk) in the compute dtype, A_log (H,), dt_bias (H*dk,) -> (T, H, dk)
    float32."""
    H = A_log.shape[0]
    sp = F.softplus(a.float() + dt_bias.float()).view(a.shape[0], H, -1)
    return -torch.exp(A_log.float())[:, None] * sp


def l2norm(x):
    """x over its last dimension, in float32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def _pair_products(left, right):
    """left (.., h, dk) . right (.., h, dk)^T -> (.., h, h): a product, or
    for the smallest halves a sum over dk (a batch of 1 x 1 products runs
    one launch a few bytes long)."""
    if left.shape[-2] <= 4:
        return (left.unsqueeze(-2) * right.unsqueeze(-3)).sum(-1)
    return torch.matmul(left, right.transpose(-1, -2))


def _decay_grams(Q, K, G):
    """The chunks' (A without beta, P without the scale): Q, K, G (nC, H, C,
    dk) float32 -> (sum_c k_jc k_mc e^(G_jc - G_mc) for m < j, sum_c q_ic
    k_mc e^(G_ic - G_mc) for m <= i), each (nC, H, C, C), zero elsewhere.

    Halving: at each block size b = C, C/2, .., 2 the pairs of a block's
    second half with its first go through r, the first half's last token,
    e^(G_j - G_m) = e^(G_j - G_r) e^(G_r - G_m), both factors at most one,
    one product a level for all blocks; every pair m < j is taken at the
    one level that parts them, and the pairs m = i of P last (e^0)."""
    nC, H, C, dk = K.shape
    A = K.new_zeros((nC, H, C, C))
    P = K.new_zeros((nC, H, C, C))
    b = C
    while b >= 2:
        h, n = b // 2, C // b
        Kb, Qb, Gb = (t.view(nC, H, n, 2, h, dk) for t in (K, Q, G))
        Gr = Gb[:, :, :, 0, h - 1:h]                                    # (nC, H, n, 1, dk)
        right = Kb[:, :, :, 0] * torch.exp(Gr - Gb[:, :, :, 0])
        later = torch.exp(Gb[:, :, :, 1] - Gr)
        for out, X in ((A, Kb), (P, Qb)):
            block = _pair_products(X[:, :, :, 1] * later, right)        # (nC, H, n, h, h)
            diag = torch.diagonal(out.view(nC, H, n, b, n, b), dim1=2, dim2=4)  # (nC, H, b, b, n)
            diag[:, :, h:, :h] = block.permute(0, 1, 3, 4, 2)
        del right, later
        b = h
    P.diagonal(dim1=-2, dim2=-1).copy_((Q * K).sum(-1))
    return A, P


def _wy(A, beta, Kg, V):
    """(W, U~) = (I + beta A)^-1 (beta Kg, beta V): the delta rule's
    correction inside each chunk. A (nC, H, C, C) strictly lower, beta
    (nC, H, C), Kg (nC, H, C, dk), V (nC, H, C, dv)."""
    dk = Kg.shape[-1]
    M = A.mul_(beta.unsqueeze(-1))
    rhs = torch.cat([Kg, V], dim=-1).mul_(beta.unsqueeze(-1))
    sol = torch.linalg.solve_triangular(M + torch.eye(M.shape[-1], device=M.device), rhs,
                                        upper=False, unitriangular=True)
    return sol[..., :dk], sol[..., dk:]


def _head_major(t, layout):
    """(T, H, d) -> (nC, H, C, d) float32 in the layout's chunks, padding
    slots zero."""
    t = torch.cat([t, t.new_zeros((1, *t.shape[1:]))])[layout.slot]    # (nC, C, H, d)
    return t.transpose(1, 2).float().contiguous()


def kda_chunked(q, k, v, g, beta, layout, n_prompts: int, chunk: int):
    """The rule over packed prompts: q, k (T, H, dk) and v (T, H, dv) in the
    compute dtype (before the L2 norm), g (T, H, dk) and beta (T, H)
    float32, `layout` the prompts' `ssd.ChunkLayout` of `chunk` slots.
    Returns o (T, H, dv) float32 and each prompt's final state (n_prompts,
    H, dk, dv) float32."""
    if chunk & (chunk - 1):
        raise ValueError(f"kda_chunked: a chunk of {chunk} tokens is not a power of two")
    dk = q.shape[-1]
    Q = _head_major(l2norm(q), layout).mul_(1.0 / math.sqrt(dk))
    K = _head_major(l2norm(k), layout)
    G = _head_major(g, layout).cumsum_(2)                                # (nC, H, C, dk)
    A, P = _decay_grams(Q, K, G)
    B = torch.cat([beta, beta.new_zeros((1, beta.shape[1]))])[layout.slot].transpose(1, 2)
    W, U = _wy(A, B, K * torch.exp(G), _head_major(v, layout))
    del A, B
    Q.mul_(torch.exp(G))                                                 # q e^G
    G_end = G[:, :, -1:]
    K.mul_(torch.exp(G_end - G))                                         # k e^(G_C - G)
    decay = torch.exp(G_end).transpose(2, 3)                             # (nC, H, dk, 1)
    del G
    H, dv = U.shape[1], U.shape[-1]
    run = U.new_zeros((n_prompts, H, dk, dv))
    O = torch.empty_like(U)
    for c in range(layout.max_chunks):
        lo, hi = layout.offsets[c], layout.offsets[c + 1]
        n = hi - lo
        S0 = run[:n]
        u = torch.baddbmm(U[lo:hi].flatten(0, 1), W[lo:hi].flatten(0, 1), S0.flatten(0, 1),
                          alpha=-1.0).view(n, H, -1, dv)
        O[lo:hi] = torch.matmul(Q[lo:hi], S0)
        O[lo:hi].add_(torch.matmul(P[lo:hi], u))
        run[:n] = torch.addcmul(torch.matmul(K[lo:hi].transpose(2, 3), u), S0, decay[lo:hi])
    o = O.transpose(1, 2).reshape(-1, H, dv)[layout.token_slot]
    final = torch.empty_like(run)
    final[layout.order] = run
    return o, final


def _write(state, k, v, beta):
    """The delta rule's write into the decayed state (in place): state (B,
    H, dk, dv), k (B, H, dk) normalised, v (B, H, dv), beta (B, H)."""
    u = beta.unsqueeze(-1) * (v - torch.matmul(k.unsqueeze(-2), state).squeeze(-2))
    state.add_(k.unsqueeze(-1) * u.unsqueeze(-2))


def kda_step(state, q, k, v, g, beta):
    """One token a row: state (B, H, dk, dv) float32, updated in place; q, k
    (B, H, dk) and v (B, H, dv) in the compute dtype, g (B, H, dk) and beta
    (B, H) float32. Returns o (B, H, dv) float32."""
    dk = q.shape[-1]
    state.mul_(torch.exp(g).unsqueeze(-1))
    _write(state, l2norm(k), v.float(), beta)
    qn = l2norm(q) * (1.0 / math.sqrt(dk))
    return torch.matmul(qn.unsqueeze(-2), state).squeeze(-2)


def gated_norm(o, gate_in, weight, eps: float, dtype):
    """The output norm: o (T, H, dv) float32 normalised to unit RMS over
    each head's channels, times the weight (dv,) and sigmoid(gate_in) (T,
    H*dv), rounded once to `dtype`: (T, H*dv)."""
    T, H, dv = o.shape
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps)
    o = o * weight.float() * torch.sigmoid(gate_in.float().view(T, H, dv))
    return o.reshape(T, H * dv).to(dtype)
