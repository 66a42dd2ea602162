"""Device milliseconds per chunk of the hybrid prefill's chunked Mamba-2
scan: the device time of the profiled sub-window's kernels whose name
contains `ssd_scan` (kernel K8, `csrc/ssd_chunk_scan.cu`), over the
sub-window's chunks. None where no such kernel ran."""

from __future__ import annotations

import harness


def read(t: dict):
    p = t.get("profile")
    if not p or not p["units"]:
        return None
    secs, n = harness.sum_kernels(p, lambda name: "ssd_scan" in name)
    return 1e3 * secs / p["units"] if n else None
