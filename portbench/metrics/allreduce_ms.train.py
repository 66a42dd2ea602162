"""Device milliseconds per step of the gradient all-reduce: rank 0's NCCL
kernels (names holding ``nccl``) in the profiled sub-window over its
steps. None where no NCCL kernel ran (one card)."""

from __future__ import annotations

import harness


def read(t: dict):
    p = t.get("profile")
    if not p or not p.get("units"):
        return None
    secs, n = harness.sum_kernels(p, lambda name: "nccl" in name.lower())
    return 1e3 * secs / p["units"] if n else None
