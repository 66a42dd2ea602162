"""Host milliseconds of `CapFiltEngine.generate_beam` per chunk of the
traced window: the time to enqueue the beam decode, which equals its run
time when the decode is bound by the host's launches."""

from __future__ import annotations


def read(t: dict):
    ms = t["host_ms"].get("decode")
    return sum(ms) / len(ms) if ms else None
