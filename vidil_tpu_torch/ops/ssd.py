"""Mamba-2's mixer arithmetic over packed prompts and one decode token:
the causal depthwise convolution, the state-space dual (SSD) scan in
chunks, the one-token state update and the gated RMSNorm.

The JAX package has no state-space layer, so nothing here replaces a TPU
kernel; everything is plain PyTorch (`models/nemotron_h.py` calls it).

Packing. A prefill holds several prompts back to back in one (T, ...)
sequence; `Packing` keeps their lengths on the host. Every prompt starts
from a zero state and no token of one prompt reaches another's: the
convolution masks the taps that would cross a prompt's start, and the
scan lays each prompt out in its own chunks of `chunk` slots, the last
one padded. A padding slot has dt = 0 and x = 0, so it decays nothing and
adds nothing, and the state after a prompt's last chunk is the state
after its last token.

The chunked scan (Mamba-2's SSD, Dao and Gu 2024): within a chunk, the
masked quadratic form ``y_i = sum_{j<=i} C_i.B_j exp(a_{j+1}+...+a_i)
dt_j x_j`` (a = dt A); across chunks, each chunk's end state carries
into the next one's outputs. The chunk list is ordered by chunk index,
then by prompt, with the prompts sorted by length, so the prompts that
have a c-th chunk are a prefix and the pass across chunks is one loop of
max-chunks steps. Every sum runs in float32: the inputs x, B and C arrive
in the compute dtype and are upcast, dt is float32, the states are
float32.

Rounding points of the program (the reference, `tests/
nemotron_h_reference.py`, is float32 throughout): the convolution sums
in float32 and rounds its SiLU output once to the compute dtype; the
scan's y stays float32 until the gated norm, which rounds once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Packing:
    """Prompts of `lengths` tokens, packed in order into one sequence."""

    lengths: tuple

    @property
    def total(self) -> int:
        return int(sum(self.lengths))

    @property
    def starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)

    @property
    def ends(self) -> np.ndarray:
        """One past each prompt's last token."""
        return np.cumsum(self.lengths).astype(np.int64)



@dataclass
class Packed:
    """A packing's index tensors on the device, uploaded once a prefill:
    each token's position in its prompt (T,), each prompt's start, end
    (one past its last token) and length (P,), and the scan's layout."""

    packing: Packing
    positions: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    lengths: torch.Tensor
    layout: "ChunkLayout"


def pack(packing: Packing, chunk: int, device, upload=None) -> Packed:
    """`packing`'s index tensors on `device`; `upload` (host array -> device
    tensor) takes each array, a plain non-blocking copy by default."""
    if upload is None:
        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
    lengths = np.asarray(packing.lengths, dtype=np.int64)
    positions = np.concatenate([np.arange(n) for n in packing.lengths]).astype(np.int64)
    return Packed(packing, upload(positions), upload(packing.starts), upload(packing.ends),
                  upload(lengths), chunk_layout(packing, chunk, upload))


@dataclass
class ChunkLayout:
    """Where each packed token sits in the scan's chunks. ``slot`` (nC,
    chunk) holds a token index or T (the zero row appended for padding);
    ``token_slot`` (T,) the flat slot of each token; the c-th step of the
    pass across chunks covers chunks ``offsets[c]:offsets[c + 1]``, whose
    prompts are ``order[:n]`` (sorted longest first)."""

    slot: torch.Tensor
    token_slot: torch.Tensor
    offsets: list
    order: torch.Tensor
    max_chunks: int


def chunk_layout(packing: Packing, chunk: int, upload) -> ChunkLayout:
    lengths = np.asarray(packing.lengths, dtype=np.int64)
    T = int(lengths.sum())
    starts = packing.starts
    n_chunks = -(-lengths // chunk)
    order = np.argsort(-lengths, kind="stable")
    max_c = int(n_chunks.max())
    rows, offsets = [], [0]
    token_slot = np.empty(T, dtype=np.int64)
    for c in range(max_c):
        for p in order:
            if n_chunks[p] <= c:
                break
            idx = starts[p] + c * chunk + np.arange(chunk)
            valid = idx < starts[p] + lengths[p]
            token_slot[idx[valid]] = len(rows) * chunk + np.nonzero(valid)[0]
            rows.append(np.where(valid, idx, T))
        offsets.append(len(rows))
    return ChunkLayout(upload(np.stack(rows)), upload(token_slot), offsets, upload(order), max_c)


def causal_conv_packed(xbc, weight, bias, packed: Packed):
    """SiLU of the causal depthwise convolution of each prompt: xbc (T, C)
    packed, weight (C, W), bias (C,). Every tap is added over the whole
    sequence at once (shifted views, no copies); the first W - 1 tokens of
    each prompt, whose taps reached into the prompt before, are then summed
    again from their own prompt's tokens alone. Sums in float32, rounded
    once to xbc's dtype."""
    T, W = xbc.shape[0], weight.shape[1]
    x = xbc.float()
    w = weight.float()
    out = torch.empty((T + 1, x.shape[1]), dtype=torch.float32, device=x.device)  # + scratch row
    torch.addcmul(bias.float(), x, w[:, W - 1], out=out[:T])
    for s in range(1, min(W, T)):
        out[s:T].addcmul_(x[:-s], w[:, W - 1 - s])
    k = torch.arange(W - 1, device=x.device)
    rows = packed.starts[:, None] + k                         # (P, W-1)
    valid = k[None] < packed.lengths[:, None]
    fix = torch.addcmul(bias.float(), x[rows.clamp(max=T - 1)], w[:, W - 1])
    for s in range(1, W):
        tap = ((k[None] >= s) & valid).unsqueeze(-1)
        fix.addcmul_(x[(rows - s).clamp(0, T - 1)] * tap, w[:, W - 1 - s])
    out[torch.where(valid, rows, T)] = fix                   # a short prompt's extra rows: scratch
    return F.silu(out[:T]).to(xbc.dtype)


def conv_state_packed(xbc, packed: Packed, width: int):
    """Each prompt's convolution state for decoding: its last width - 1
    inputs, (P, C, width - 1) in xbc's dtype, zeros before a short
    prompt's first token."""
    back = torch.arange(width - 1, 0, -1, device=xbc.device)  # width-1 .. 1 tokens back
    idx = packed.ends[:, None] - back[None]                    # (P, width-1)
    valid = back[None] <= packed.lengths[:, None]
    rows = xbc[idx.clamp_min(0)] * valid[..., None].to(xbc.dtype)
    return rows.transpose(1, 2).contiguous()


def conv_step(state, x, weight, bias):
    """One token through the convolution: state (B, C, W-1) is updated in
    place (shifted by one, x appended); returns SiLU of the sum in x's
    dtype, summed in float32."""
    window = torch.cat([state, x.unsqueeze(-1)], dim=-1)       # (B, C, W)
    out = (window.float() * weight.float()).sum(-1) + bias.float()
    state.copy_(window[..., 1:])
    return F.silu(out).to(x.dtype)


def _head_major(t):
    """(nC, L, H, ...) -> a contiguous float32 (nC, H, L, ...)."""
    t = t.transpose(1, 2)
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def ssd_chunked(x, dt, A, B, C, D, layout: ChunkLayout, n_prompts: int, chunk: int):
    """The scan over packed prompts. x (T, H, P), B and C (T, G, N) in the
    compute dtype; dt (T, H) float32 (after softplus); A and D (H,)
    float32. Returns y (T, H, P) float32, D's skip included, and each
    prompt's final state (n_prompts, H, P, N) float32. The chunks are laid
    out head-major, (nC, H, L, ...), so that every group of heads is one
    contiguous block and no elementwise pass runs over a strided view."""
    T, H, Pd = x.shape
    G, N = B.shape[1], B.shape[2]
    hg = H // G
    dev = x.device

    def chunks(t):  # (T, ...) -> (nC, L, ...) in t's dtype, padding slots zero
        return torch.cat([t, t.new_zeros((1, *t.shape[1:]))])[layout.slot]

    dtc = chunks(dt).transpose(1, 2).contiguous()              # (nC, H, L) float32
    cs = torch.cumsum(dtc * A[:, None], dim=-1)                # (nC, H, L), decreasing
    xdt = _head_major(chunks(x))                               # (nC, H, L, P)
    xdt.mul_(dtc.unsqueeze(-1))
    del dtc
    Bc = _head_major(chunks(B))                                # (nC, G, L, N)
    Cc = _head_major(chunks(C))
    nC = xdt.shape[0]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
    y = torch.empty_like(xdt)
    states = torch.empty((nC, H, Pd, N), dtype=torch.float32, device=dev)
    for g in range(G):  # one group of heads at a time bounds the (nC, hg, L, L) terms
        hs = slice(g * hg, (g + 1) * hg)
        cb = torch.matmul(Cc[:, g], Bc[:, g].transpose(1, 2))     # (nC, L, L)
        csg = cs[:, hs]                                           # (nC, hg, L)
        w = (csg.unsqueeze(-1) - csg.unsqueeze(-2)).masked_fill_(~causal, float("-inf"))
        w.exp_().mul_(cb.unsqueeze(1))                            # (nC, hg, L, L)
        y[:, hs] = torch.matmul(w, xdt[:, hs])
        del cb, w
        # the chunk's own contribution to its end state: sum_j decay dt_j x_j B_j^T
        xe = xdt[:, hs] * torch.exp(csg[..., -1:] - csg).unsqueeze(-1)  # (nC, hg, L, P)
        states[:, hs] = torch.matmul(xe.transpose(2, 3), Bc[:, g].unsqueeze(1))
        del xe
    del xdt
    # across chunks: the state entering each chunk, prompts reset to zero
    chunk_decay = torch.exp(cs[:, :, -1])                      # (nC, H)
    run = torch.zeros((n_prompts, H, Pd, N), dtype=torch.float32, device=dev)
    entering = torch.empty_like(states)
    for c in range(layout.max_chunks):
        lo, hi = layout.offsets[c], layout.offsets[c + 1]
        n = hi - lo
        entering[lo:hi] = run[:n]
        run[:n] = torch.addcmul(states[lo:hi], run[:n], chunk_decay[lo:hi, :, None, None])
    del states
    # outputs from the entering state: exp(cs_i) C_i . h
    for g in range(G):
        hs = slice(g * hg, (g + 1) * hg)
        yo = torch.matmul(Cc[:, g].unsqueeze(1), entering[:, hs].transpose(2, 3))  # (nC, hg, L, P)
        y[:, hs].addcmul_(yo, torch.exp(cs[:, hs]).unsqueeze(-1))
        del yo
    y_tok = y.permute(0, 2, 1, 3).reshape(nC * chunk, H, Pd)[layout.token_slot]
    y_tok.addcmul_(x.float(), D[:, None])
    final = torch.empty_like(run)
    final[layout.order] = run
    return y_tok, final


def ssd_step(state, x, dt, A, B, C, D):
    """One token of the recurrence h <- exp(dt A) h + dt x B^T, y = h C +
    D x, for a batch of rows: state (Bt, H, P, N) float32, updated in
    place; x (Bt, H, P) and B, C (Bt, G, N) in the compute dtype; dt (Bt,
    H) float32. Returns y (Bt, H, P) float32."""
    H, G = x.shape[1], B.shape[1]
    Bh = B.float().repeat_interleave(H // G, dim=1)            # (Bt, H, N)
    Ch = C.float().repeat_interleave(H // G, dim=1)
    xf = x.float()
    state.mul_(torch.exp(dt * A)[..., None, None])
    state.add_((dt.unsqueeze(-1) * xf).unsqueeze(-1) * Bh.unsqueeze(2))
    y = torch.matmul(state, Ch.unsqueeze(-1)).squeeze(-1)     # (Bt, H, P)
    return y + D[:, None] * xf


def gated_rms_norm(y, z, weight, group: int, eps: float, dtype):
    """Mamba-2's gated norm: y * silu(z), normalised to unit RMS over each
    group of `group` channels, rounded to `dtype`, times the weight."""
    h = y.float() * F.silu(z.float())
    hg = h.view(*h.shape[:-1], -1, group)
    hg = hg * torch.rsqrt(hg.pow(2).mean(-1, keepdim=True) + eps)
    return hg.view_as(h).to(dtype) * weight.to(dtype)
