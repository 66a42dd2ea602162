"""Host milliseconds of `CapFiltEngine.complete_chunk` per chunk of the
traced window: the wait for the chunk's device results, detokenization,
deduplication, the fused filter's host checks, and in filter-only traffic
the host tokenization and the grouped ITM call with its readback."""

from __future__ import annotations


def read(t: dict):
    ms = t["host_ms"].get("complete")
    return sum(ms) / len(ms) if ms else None
