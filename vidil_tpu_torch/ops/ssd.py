"""Mamba-2's mixer arithmetic over packed prompts and one decode token:
the causal depthwise convolution, the state-space dual (SSD) scan in
chunks, the one-token state update and the gated RMSNorm.

The JAX package has no state-space layer, so nothing here replaces a TPU
kernel (`models/nemotron_h.py` calls it). On the card the chunked scan runs
on kernel K8 (``csrc/ssd_chunk_scan.cu``, `ssd_chunked`), which reads x, B,
C and dt in place from the packed rows and keeps its intermediates and each
prompt's state on chip; `ssd_chunked_ref` is its plain version, which the
CPU runs and the tests hold K8 to. The convolution, the one-token update and
the gated norm are plain PyTorch.

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

import ctypes
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
    prompts are ``order[:n]`` (sorted longest first). ``prompts`` (n, 3)
    int32 holds each prompt's index, start and length in that order (K8
    reads its rows in place by them)."""

    slot: torch.Tensor
    token_slot: torch.Tensor
    offsets: list
    order: torch.Tensor
    max_chunks: int
    prompts: torch.Tensor


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
    prompts = np.stack([order, starts[order], lengths[order]], axis=1).astype(np.int32)
    return ChunkLayout(upload(np.stack(rows)), upload(token_slot), offsets, upload(order), max_c,
                       upload(prompts))


def causal_conv_packed(xbc, weight, bias, packed: Packed):
    """SiLU of the causal depthwise convolution of each prompt: xbc (T, C)
    packed, weight (C, W), bias (C,) or None. Every tap is added over the whole
    sequence at once (shifted views, no copies); the first W - 1 tokens of
    each prompt, whose taps reached into the prompt before, are then summed
    again from their own prompt's tokens alone. Sums in float32, rounded
    once to xbc's dtype."""
    T, W = xbc.shape[0], weight.shape[1]
    x = xbc.float()
    w = weight.float()
    bias = _bias(bias, x)
    out = torch.empty((T + 1, x.shape[1]), dtype=torch.float32, device=x.device)  # + scratch row
    torch.addcmul(bias, x, w[:, W - 1], out=out[:T])
    for s in range(1, min(W, T)):
        out[s:T].addcmul_(x[:-s], w[:, W - 1 - s])
    k = torch.arange(W - 1, device=x.device)
    rows = packed.starts[:, None] + k                         # (P, W-1)
    valid = k[None] < packed.lengths[:, None]
    fix = torch.addcmul(bias, x[rows.clamp(max=T - 1)], w[:, W - 1])
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


def _bias(bias, x):
    """A convolution's bias in float32; none is zero."""
    return bias.float() if bias is not None else x.new_zeros((), dtype=torch.float32)


def conv_step(state, x, weight, bias):
    """One token through the convolution: state (B, C, W-1) is updated in
    place (shifted by one, x appended); returns SiLU of the sum in x's
    dtype, summed in float32. `bias` (C,) or None."""
    window = torch.cat([state, x.unsqueeze(-1)], dim=-1)       # (B, C, W)
    out = (window.float() * weight.float()).sum(-1) + _bias(bias, x)
    state.copy_(window[..., 1:])
    return F.silu(out).to(x.dtype)


def _head_major(t):
    """(nC, L, H, ...) -> a contiguous float32 (nC, H, L, ...)."""
    t = t.transpose(1, 2)
    return torch.empty(t.shape, dtype=torch.float32, device=t.device).copy_(t)


def ssd_chunked_ref(x, dt, A, B, C, D, layout: ChunkLayout, n_prompts: int, chunk: int):
    """The plain version of `ssd_chunked`. The chunks are laid out
    head-major, (nC, H, L, ...), so that every group of heads is one
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


# K8's widths: head dim, state size, chunk
KERNEL_P, KERNEL_N, KERNEL_CHUNK = 64, 128, 128
# launches of K8 by this process (one per call), for showing that a run
# went through it
launch_counts = {"ssd_scan": 0}


def check_kernel_operands(x, dt, A, B, C, D, layout: ChunkLayout, n_prompts: int, chunk: int):
    """What K8 takes, raised otherwise: x (T, H, 64), B and C (T, G, 128)
    in bf16 with unit stride inside a row and 16-byte-aligned rows (views
    of the convolution's output will do), G dividing H; dt (T, H), A and D
    (H,) contiguous float32; chunks of 128; the layout's (n_prompts, 3)
    int32 prompt table; everything on one card. Returns (T, H, G)."""
    if x.dtype != torch.bfloat16 or B.dtype != torch.bfloat16 or C.dtype != torch.bfloat16:
        raise TypeError(f"ssd_scan kernel takes bf16 x, B, C, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan kernel takes float32 {name}, got {t.dtype}")
    if x.dim() != 3 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    T, H, P = x.shape
    G, N = B.shape[1], B.shape[2]
    if (P, N, chunk) != (KERNEL_P, KERNEL_N, KERNEL_CHUNK) or B.shape[0] != T or H % G:
        raise ValueError(f"ssd_scan kernel takes P {KERNEL_P}, N {KERNEL_N}, chunk "
                         f"{KERNEL_CHUNK} and G dividing H, got x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}, chunk {chunk}")
    if dt.shape != (T, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} for x {tuple(x.shape)}")
    prompts = layout.prompts
    if prompts.dtype != torch.int32 or prompts.shape != (n_prompts, 3) or n_prompts < 1:
        raise ValueError(f"ssd_scan: the layout's prompt table must be int32 ({n_prompts}, 3)")
    for t in (dt, A, D, B, C, prompts):
        if t.device != x.device:
            raise ValueError("ssd_scan: every operand must be on x's device")
    if not (dt.is_contiguous() and A.is_contiguous() and D.is_contiguous()
            and prompts.is_contiguous()):
        raise ValueError("ssd_scan: dt, A, D and the prompt table must be contiguous")
    for name, t, inner in (("x", x, (P, 1)), ("B", B, (N, 1)), ("C", C, (N, 1))):
        if tuple(t.stride()[1:]) != inner or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} needs unit stride inside a row and "
                             f"16-byte-aligned rows, got strides {t.stride()}")
    if T >= 2**31:
        raise ValueError(f"ssd_scan: {T} tokens exceed int32 indexing")
    return T, H, G


def _launch(x, dt, A, B, C, D, layout: ChunkLayout, n_prompts: int, chunk: int):
    T, H, G = check_kernel_operands(x, dt, A, B, C, D, layout, n_prompts, chunk)
    y = torch.empty((T, H, KERNEL_P), dtype=torch.float32, device=x.device)
    final = torch.empty((n_prompts, H, KERNEL_P, KERNEL_N), dtype=torch.float32,
                        device=x.device)
    err = _kernel_fn()(x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       D.data_ptr(), layout.prompts.data_ptr(), y.data_ptr(), final.data_ptr(),
                       x.stride(0), B.stride(0), C.stride(0), H, G, n_prompts, x.device.index,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    launch_counts["ssd_scan"] += 1
    return y, final


_fns: dict = {}


def _kernel_fn():
    if not _fns:
        from vidil_tpu_torch.ops import _build

        fn = _build.load("ssd_chunk_scan").vidil_ssd_chunk_scan
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        _fns["fwd"] = fn
    return _fns["fwd"]


def ssd_chunked(x, dt, A, B, C, D, layout: ChunkLayout, n_prompts: int, chunk: int):
    """The scan over packed prompts. x (T, H, P), B and C (T, G, N) in the
    compute dtype; dt (T, H) float32 (after softplus); A and D (H,)
    float32. Returns y (T, H, P) float32, D's skip included, and each
    prompt's final state (n_prompts, H, P, N) float32. CUDA tensors run
    K8, CPU tensors the plain version `ssd_chunked_ref`."""
    if x.is_cuda:
        return _launch(x, dt, A, B, C, D, layout, n_prompts, chunk)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, D, layout, n_prompts, chunk)
    raise RuntimeError(f"ssd_chunked: no kernel for device {x.device}")


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
