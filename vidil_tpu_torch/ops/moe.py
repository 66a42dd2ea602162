"""Nemotron-H's mixture of experts: the router, the routed experts on the
grouped GEMM (kernel K7, `ops/grouped_expert_gemm.py`) and the shared
expert.

`route`: router logits in float32 (the hidden state and the router's
weight upcast), sigmoid scores s; the top k experts by s plus the
correction bias; their weights the chosen s (not the biased ones),
normalised to sum 1 and scaled by the routed scaling factor.

`routed_experts`: the (token, expert) pairs sorted by expert, the token
rows gathered in that order, K7 twice (up with the relu^2 epilogue, then
down), and the weighted sum of each token's k rows in float32, in a fixed
order: no atomics, so a result is the same bits run to run. The expert
row offsets come from the device (an integer scatter-add and a cumulative
sum), so nothing waits for the host and a decode step can be captured.

`shared_expert`: down(relu(up(x))^2) in the compute dtype, the activation
in float32. Every function is reached through this module's namespace, so
a test can replace one.
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


def routed_experts(x, idx, weights, up, down):
    """sum_j weights[t, j] * down_e(relu(up_e(x_t))^2), e = idx[t, j]:
    x (T, D), up (E, I, D), down (E, D, I) -> (T, D) float32."""
    T, k = idx.shape
    order, offsets = expert_offsets(idx, up.shape[0])
    rows = x[order // k]                                   # (T*k, D), sorted by expert
    h = k7.grouped_expert_gemm(rows, up, offsets, relu2=True)
    del rows
    y = k7.grouped_expert_gemm(h, down, offsets)
    del h
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=order.device)
    back = back.view(T, k)                                 # row of y of each (token, slot)
    out = y[back[:, 0]].float() * weights[:, :1]
    for j in range(1, k):                                  # slot by slot: (T, D) temporaries
        out.addcmul_(y[back[:, j]].float(), weights[:, j:j + 1])
    return out


def shared_expert(x, up, down):
    h = F.linear(x, up)
    h = torch.relu(h.float()).square().to(x.dtype)
    return F.linear(h, down)


def moe_layer(p, x, cfg, probe=None):
    """The MoE mixer on normed x (T, D): routed plus shared, in x's dtype.
    `probe`, when given, collects each call's expert ids."""
    with annotate("lm.route"):
        idx, w = route(x, p["router"], p["router_bias"], cfg.num_experts_per_tok,
                       cfg.routed_scaling_factor, cfg.norm_topk_prob)
    if probe is not None:
        probe.setdefault("route", []).append(idx)
    with annotate("lm.experts"):
        out = routed_experts(x, idx, w, p["up"], p["down"])
        out += shared_expert(x, p["shared_up"], p["shared_down"]).float()
    return out.to(x.dtype)
