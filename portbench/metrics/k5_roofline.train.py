"""K5's share of its roofline: its calls' least time (flops.block_bound_s,
backward, at 197 real tokens) over their device time between CUDA events
recorded around each `_launch_bwd` call of the traced window, in percent."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("k5")
    return 100.0 * len(ms) * t["k5_bound_s"] * 1e3 / sum(ms) if ms else None
