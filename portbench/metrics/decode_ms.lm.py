"""Device milliseconds per chunk of the greedy decode (the answer's
tokens after the first, through the hybrid cache, replayed from CUDA
graphs), between CUDA events recorded around each `LMAnswerEngine._decode`
call of the traced window."""

from __future__ import annotations


def read(t: dict):
    ms = t["device_ms"].get("decode")
    return sum(ms) / t["chunks"] if ms and t["chunks"] else None
