"""Learning-rate schedules (reference: utils.py:6-22), the port's own copy
of the JAX package's: pure functions of the epoch or step; the trainer
writes the value into the optimizer's param groups."""

from __future__ import annotations

import math


def cosine_lr_schedule(epoch: float, max_epoch: int, init_lr: float, min_lr: float) -> float:
    """Cosine decay from init_lr to min_lr over max_epoch epochs."""
    return (init_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch)) + min_lr


def warmup_lr_schedule(step: float, max_step: int, init_lr: float, max_lr: float) -> float:
    """Linear warmup from init_lr to max_lr over max_step steps."""
    return min(max_lr, init_lr + (max_lr - init_lr) * step / max_step)


def step_lr_schedule(epoch: float, init_lr: float, min_lr: float, decay_rate: float) -> float:
    """Exponential step decay with a floor."""
    return max(min_lr, init_lr * (decay_rate**epoch))
