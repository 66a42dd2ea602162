"""Device milliseconds per train step: the summed device time of every
kernel in the profiled sub-window over its steps."""

from __future__ import annotations


def read(t: dict):
    p = t.get("profile")
    if not p or not p["units"] or not p["kernels"]:
        return None
    return 1e3 * sum(p["by_name"].values()) / p["units"]
