"""Device milliseconds per chunk of the ViT encodes (captioner and
filterer), between CUDA events recorded around each `_encode` call of the
traced window, summed over the chunk's encodes."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("encode")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
