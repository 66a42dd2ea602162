"""Device milliseconds per chunk of the prefill's KDA mixers (Kimi
Linear's 20 gated delta-rule layers: projections, convolution, the
chunked rule, the gated norm), between CUDA events recorded around each
`kimi_linear.kda_prefill` call of the traced window. None where no such
call was recorded."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("kda")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
