"""Tiny stand-ins for the cells' configurations and traffic, for runs of
the whole harness on the CPU in the benchmark's tests."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    c = copy.deepcopy(_load("configs", f"{name}.json"))
    c["vit"].update(image_size=32, hidden_size=64, num_layers=2, num_heads=2)
    c["med"].update(hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                    max_position_embeddings=64, encoder_width=64)
    if "itm_embed_dim" in c:
        c["itm_embed_dim"] = 16
    return c


# the b12 step over four ranks, a cell of the tests alone: the harness
# runs a cell on four chips as four processes, and this one drives that path
FOUR_RANKS = {"name": "caption_ft_four_ranks", "config": "blip_caption_base224",
              "traffic": "msrvtt_b12", "chips": 4,
              "why": "the b12 step data parallel over four ranks (the benchmark's tests)"}


# the filter-only CapFilt mix, kept out of BENCHMARK.json (its runs on the
# card swing with the host's speed; PERF.md) and driven here so that its
# files, the grouped ITM's check and its fault stay sound for a later entry
FILTER_ONLY = {"name": "capfilt_msrvtt_filter_only", "config": "blip_capfilt_base384",
               "traffic": "msrvtt_filter_only", "chips": 1,
               "why": "the beam cell's chunks with caption off (the benchmark's tests)"}


def bench() -> dict:
    """BENCHMARK.json with the tests' four-rank and filter-only cells added."""
    b = _load("..", "BENCHMARK.json")
    b["workloads"] += [FOUR_RANKS, FILTER_ONLY]
    return b


def entry(cell: str) -> dict:
    return next(w for w in bench()["workloads"] if w["name"] == cell)


def traffic(name: str, chips: int = 1) -> dict:
    t = copy.deepcopy(_load("traffic", f"{name}.json"))
    t["image_size"] = 32
    if "pool_chunks" in t:
        t.update(videos=2, frames=2, captions=3, caption_words=[3, 8], pool_chunks=3,
                 warmup_chunks=1, profile_from=1, profile_chunks=2, check_chunks=2)
    else:
        t.update(videos=2 * chips, frames=2, tokens=16, caption_words=[3, 8],
                 pool_batches=4, profile_from=1, profile_steps=2)
    return t


def workload(name: str) -> dict:
    """The cell's file; the four-rank cell takes b12's."""
    file = "caption_ft_msrvtt_b12" if name == FOUR_RANKS["name"] else name
    return dict(copy.deepcopy(_load("workloads", f"{file}.json")), name=name)


def run_kwargs(cell: str) -> dict:
    """run.main's keywords for a tiny run of `cell` on the CPU."""
    e = entry(cell)
    return dict(device="cpu", bench=bench(), workload=workload(cell),
                config=config(e["config"]), traffic=traffic(e["traffic"], e["chips"]))
