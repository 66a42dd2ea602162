"""The language models' mixture of experts (Nemotron-H's relu^2 experts and
Kimi Linear's SwiGLU ones): the router, the routed experts on the grouped
GEMM (kernel K7, `ops/grouped_expert_gemm.py`) and the shared expert.

`route`: router logits in float32 (the hidden state and the router's
weight upcast), sigmoid scores s; the top k experts by s plus the
correction bias; their weights the chosen s (not the biased ones),
normalised to sum 1 and scaled by the routed scaling factor.

`routed_experts`: the (token, expert) pairs sorted by expert, the token
rows gathered in that order, K7 twice (up with the relu^2 or the SwiGLU
epilogue, then down, storing), and the weighted sum of each token's k
rows in float32, in a fixed order: no atomics, so a result is the same bits run to
run. The expert row offsets come from the device (an integer scatter-add
and a cumulative sum), so nothing waits for the host and a decode step can
be captured.

The held range. A card of an expert-parallel deployment holds the E
experts [first, first + E) of the router's: the router scores all of
them, and the layer computes the part of the result its own experts give.
Pairs routed elsewhere sort past the held experts' rows, in a bucket of
their own that no launch computes, and read a zero row in the weighted
sum (on one card the layer runs without the deployment's exchange). Nemotron-H holds all its
experts (first 0, E the router's): its bucket is empty.

`shared_expert`: down(act(up(x))) in the compute dtype, the activation in
float32: relu^2 or SwiGLU (`act`, by K7's epilogue names). A SwiGLU
weight (experts', shared expert's or a dense MLP's) holds its gate and up
rows interleaved in blocks of 8 (rows 16m..16m+7 the gate's 8m..8m+7,
rows 16m+8..16m+15 the up's), the layout in which one K7 tile holds both
halves of its columns (`k7.silu_gate`). Every function is reached through this module's
namespace, so a test can replace one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vidil_tpu_torch.ops import grouped_expert_gemm as k7
from vidil_tpu_torch.utils.profiling import annotate


def route(x, weight, bias, k: int, scale: float, norm: bool):
    """x (T, D) -> (expert ids (T, k) int64, weights (T, k) float32)."""
    scores = torch.sigmoid(F.linear(x.float(), weight.float()))
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def expert_offsets(idx, n_experts: int):
    """(pair order sorted by expert, int32 row offsets (E + 1,)) of the
    flattened (token, slot) pairs of idx (T, k)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=idx.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


def held_rows(device) -> torch.Tensor:
    """The (1,) int64 counter of the rows that held experts took in calls
    of at least `k7.SMALL_ROWS` routed pairs (the prefill's, which their
    operations bound: `portbench/flops_kimi.py`); made at its first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _held_rows:
        _held_rows[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _held_rows[device]


_held_rows: dict = {}


def held_offsets(idx, first: int, n_held: int):
    """`expert_offsets` of idx (T, k) for the experts [first, first +
    n_held) held here: pairs routed to others sort last, past offsets[n_held]
    (their bucket, which no launch computes)."""
    local = idx - first
    local = torch.where((local >= 0) & (local < n_held), local, n_held)
    order, offsets = expert_offsets(local, n_held + 1)
    return order, offsets[:n_held + 1]


def routed_experts(x, idx, weights, up, down, first: int = 0, act: str = "relu2"):
    """sum_j weights[t, j] * down_e(act(up_e(x_t))), e = idx[t, j]: x (T,
    D), up (E, I, D) (``act="swiglu"``: (E, 2I, D), interleaved), down (E,
    D, I) -> (T, D) float32. up and down hold the experts [first, first + E)
    of the router's numbering; pairs routed to others add nothing."""
    T, k = idx.shape
    E = up.shape[0]
    order, offsets = held_offsets(idx, first, E)
    if T * k >= k7.SMALL_ROWS:
        held_rows(x.device).add_(offsets[E:])
    R = order.numel()
    # (T*k + 1, D), sorted by expert; the last row lies past offsets[E] too
    rows = x[torch.cat([order // k, order.new_zeros(1)])]
    h = k7.grouped_expert_gemm(rows, up, offsets, act)
    del rows
    y = k7.grouped_expert_gemm(h, down, offsets, "store")
    del h
    y[R].zero_()  # no launch wrote it: every pair routed elsewhere reads it
    back = torch.empty_like(order)
    back[order] = torch.arange(R, device=order.device)
    back = torch.where((idx >= first) & (idx < first + E), back.view(T, k), R)
    out = y[back[:, 0]].float() * weights[:, :1]
    for j in range(1, k):                                  # slot by slot: (T, D) temporaries
        out.addcmul_(y[back[:, j]].float(), weights[:, j:j + 1])
    return out


def shared_expert(x, up, down, act: str = "relu2"):
    h = F.linear(x, up)
    if act == "swiglu":
        h = k7.silu_gate(h).to(x.dtype)
    else:
        h = torch.relu(h.float()).square().to(x.dtype)
    return F.linear(h, down)


def moe_layer(p, x, cfg, probe=None, first: int = 0):
    """The MoE mixer on normed x (T, D): routed plus shared, in x's dtype.
    `probe`, when given, collects each call's expert ids; `first` is the
    router's number of the first expert held here (see the module's
    docstring). A layer with ``gate_up`` weights has SwiGLU experts, else
    relu^2 ones."""
    with annotate("lm.route"):
        idx, w = route(x, p["router"], p["router_bias"], cfg.num_experts_per_tok,
                       cfg.routed_scaling_factor, cfg.norm_topk_prob)
    if probe is not None:
        probe.setdefault("route", []).append(idx)
    with annotate("lm.experts"):
        if "gate_up" in p:
            out = routed_experts(x, idx, w, p["gate_up"], p["down"], first, "swiglu")
            out += shared_expert(x, p["shared_gate_up"], p["shared_down"], "swiglu").float()
        else:
            out = routed_experts(x, idx, w, p["up"], p["down"], first)
            out += shared_expert(x, p["shared_up"], p["shared_down"]).float()
    return out.to(x.dtype)
