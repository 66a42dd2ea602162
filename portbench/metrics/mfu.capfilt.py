"""The whole chunk's share of the chip's peak: the matmul operations of
the chunks completed in the traced window (flops.py, no recompute) over
the window's seconds and the H100's 989 TFLOP/s in bf16, in percent."""

from __future__ import annotations

import flops


def read(t: dict):
    if not t["window_s"]:
        return None
    return 100.0 * t["flops"] / (t["window_s"] * t["chips"] * flops.PEAK_BF16)
