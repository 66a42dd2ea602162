"""Device milliseconds per chunk of the grouped ITM calls (the fused
filter's, or filter-only's), between CUDA events recorded around each
`_itm_grouped` call of the traced window."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("itm")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
