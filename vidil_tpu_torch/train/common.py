"""Shared trainer setup: config normalisation, batch size, optimizer.

Counterpart of ``vidil_tpu/train/common.py`` (`training_cfgs`,
`resolve_train_batch`) and of ``vidil_tpu/train/retrieval.py:make_optimizer``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from vidil_tpu_torch.models.convert import named_leaves


def training_cfgs(vit_cfg, med_cfg, med_remat: bool = True):
    """Return (vit_cfg, med_cfg) for autodiff training: MED-layer remat on
    by default (the saved per-layer activations are what fill device memory
    at large batches); the ViT keeps its own ``remat``.

    The ViT runs the classic schedule: blocks one by one, the attention
    through the flash kernels (forward with logsumexp rows, backward). The
    JAX package's trainers default to its fused-block schedule on a TPU
    (kernels K4/K5 of ops/fused_vit_block.py, which are not ported); off a
    TPU, or with VIDIL_TPU_TRAIN_FUSED_BLOCK=0, they run the classic one.
    Asking for the fused schedule (VIDIL_TPU_TRAIN_FUSED_BLOCK=1) raises.
    """
    if os.environ.get("VIDIL_TPU_TRAIN_FUSED_BLOCK") == "1":
        raise NotImplementedError(
            "vidil_tpu_torch: the fused-block training schedule (use_fused_block / "
            "use_fused_block_bwd) is not ported yet")
    if med_remat and not med_cfg.remat:
        med_cfg = dataclasses.replace(med_cfg, remat=True)
    return vit_cfg, med_cfg


def resolve_train_batch(config: dict, key: str, default: int | None = None) -> int:
    """The reference's ``<key>`` batch. The JAX package prefers a
    ``<key>_tpu`` yaml key, a batch tuned for a TPU chip (PARITY.md
    divergence 14); the port reads the reference key and says what it
    ignored."""
    base = config.get(key, default)
    tuned = config.get(f"{key}_tpu")
    if tuned is not None and (base is None or int(tuned) != int(base)):
        print(f"batch: using {key}={base}; ignoring {key}_tpu={tuned} "
              f"(a batch tuned for a TPU chip)", flush=True)
    return int(base)


def make_optimizer(params, init_lr: float, weight_decay: float = 0.05):
    """AdamW over every parameter leaf, as ``optax.adamw`` (no mask):
    betas (0.9, 0.999), eps 1e-8, decoupled weight decay. One param group;
    the trainer sets the per-epoch LR with `set_lr`."""
    leaves = [p for _, p in named_leaves(params)]
    return torch.optim.AdamW(leaves, lr=init_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
