"""K6's share of its roofline in the profiled sub-window: its launches'
least time over the device time of its `decode_cross_attention` kernels, in
percent. The least time of a launch is one beam step's
(flops.attention_bound_s at the beam cell's frames, heads, beams, 577 image
tokens and head width: q, K, V and the output read or written once, bound by
bytes); the prefill's launches carry a few more query rows, so the share can
only err low. None where no such kernel ran (a program without K6)."""

from __future__ import annotations

import json
import os

import flops
import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "capfilt_msrvtt_beam"


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def step_bound_s() -> float:
    """One beam step's K6 launch at the beam cell's shapes."""
    bench = _load(os.path.dirname(HERE), "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg = _load(HERE, "configs", f"{entry['config']}.json")
    traffic = _load(HERE, "traffic", f"{entry['traffic']}.json")
    vit, med = cfg["vit"], cfg["med"]
    tokens = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
    return flops.attention_bound_s(traffic["videos"] * traffic["frames"], med["num_heads"],
                                   cfg["generation"]["num_beams"], tokens,
                                   med["hidden_size"] // med["num_heads"])


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    secs, n = harness.sum_kernels(p, lambda name: "decode_cross_attention" in name)
    return 100.0 * n * step_bound_s() / secs if n else None
