"""K7's share of its roofline in the profiled sub-window: its launches'
least time over the device time of its `grouped_gemm_bf16` kernels, in
percent. The least time (`flops_lm.k7_bound_s`, worked out by the driver
for the profiled chunks): each prefill launch's 2 R N K operations at the
H100's 989 TFLOP/s (R the chunk's routed rows), each decode launch's bytes
at 3.35 TB/s (its rows in and out, and each expert weight it read once, as
the kernel counts them). None where no such kernel ran."""

from __future__ import annotations

import harness


def read(t: dict):
    p = t.get("profile")
    if not p or "k7_bound_s" not in t:
        return None
    secs, n = harness.sum_kernels(p, lambda name: "grouped_gemm_bf16" in name)
    return 100.0 * t["k7_bound_s"] / secs if n else None
