"""Device milliseconds per chunk of the hybrid prefill (every layer over
the chunk's packed prompts, the head at each prompt's last position),
between CUDA events recorded around each `LMAnswerEngine._prefill` call of
the traced window."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("prefill")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
