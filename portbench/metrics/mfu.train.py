"""The whole step's share of the chips' peak: the forward and backward
matmul operations of the global steps in the traced window (flops.py, no
remat or K5 recompute counted) over the window's seconds, the cell's chips
and the H100's 989 TFLOP/s in bf16, in percent."""

from __future__ import annotations

import flops


def read(t: dict):
    if not t["window_s"]:
        return None
    return 100.0 * t["flops"] / (t["window_s"] * t["chips"] * flops.PEAK_BF16)
