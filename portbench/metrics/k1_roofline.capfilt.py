"""K1's share of its roofline in the profiled sub-window: its launches'
least time (flops.attention_bound_s at the ViT's 577 real tokens) over
the device time of its `flash_fwd` kernels, in percent."""

from __future__ import annotations

import harness


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    secs, n = harness.sum_kernels(p, lambda name: "flash_fwd" in name)
    return 100.0 * n * t["k1_bound_s"] / secs if n else None
