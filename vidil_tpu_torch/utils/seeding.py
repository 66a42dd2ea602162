"""Seeding: python ``random`` and numpy with ``seed + rank`` (host-side
RNG state drives frame sampling, e.g. headtail/rand), plus torch's."""

from __future__ import annotations

import random

import numpy as np
import torch

from vidil_tpu_torch.utils.dist import get_rank


def seed_everything(seed: int, add_rank: bool = True) -> int:
    """Seed python, numpy and torch RNGs with ``seed (+ rank)``; return the seed used."""
    s = seed + get_rank() if add_rank else seed
    random.seed(s)
    np.random.seed(s)
    torch.manual_seed(s)
    return s


def make_generator(seed: int, step: int = 0, device="cpu") -> torch.Generator:
    """The port's stand-in for the JAX package's per-step key
    ``fold_in(PRNGKey(seed), step)``: a torch.Generator on `device` seeded
    with ``(seed * 1000003 + step) mod 2**63``. The trainers draw their
    hard negatives from ``make_generator(seed, step)`` and the feature
    queues from ``make_generator(seed, -1)``. JAX's streams themselves
    cannot be reproduced: the distributions are the same, the draws differ."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + step) % 2**63)
    return g
