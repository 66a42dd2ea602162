"""Host milliseconds to enqueue one train step: the step call's return,
before the loss is read back, per step of the traced window."""

from __future__ import annotations


def read(t: dict):
    ms = t["host_ms"].get("train_step")
    return sum(ms) / len(ms) if ms else None
