"""Device milliseconds per chunk of the prefill's MLA mixers (Kimi
Linear's 7 latent-attention layers: projections, the latent's expansion,
attention a prompt, the cache's latent rows), between CUDA events
recorded around each `kimi_linear.mla_prefill` call of the traced
window. None where no such call was recorded."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("mla")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
