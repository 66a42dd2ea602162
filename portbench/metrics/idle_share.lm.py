"""The device's idle share of the profiled sub-window: one less the union
of its kernels' intervals over the window, in percent."""

from __future__ import annotations


def read(t: dict):
    p = t.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
