"""Shared trainer setup: config normalisation, batch size, optimizer and
the train state of the caption and VQA trainers.

Counterpart of ``vidil_tpu/train/common.py`` (`training_cfgs`,
`resolve_train_batch`) and of ``vidil_tpu/train/retrieval.py:make_optimizer``.

Data parallelism: each rank's step takes its rows of the global batch and
computes its share of the global batch's loss (a mean over the global
batch's tokens or rows, whose counts come from an all-reduce); the
gradients are summed over the ranks before AdamW (`apply_gradients`), so
every rank takes the one-process global-batch step.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from vidil_tpu_torch.models.convert import named_leaves


def training_cfgs(vit_cfg, med_cfg, med_remat: bool = True, default_fused_bwd: bool = True):
    """Return (vit_cfg, med_cfg) adjusted for autodiff training, as the JAX
    package's `training_cfgs` does:

    * MED-layer remat on by default (the saved per-layer activations are
      what fill device memory at large batches);
    * the fused MLP (kernel K3) off under autodiff;
    * the ViT's schedule from ``VIDIL_TPU_TRAIN_FUSED_BLOCK``: ``0`` gives
      the classic schedule (blocks one by one, attention through
      `attention_auto`: the flash kernels K1 + K2 where the reference's
      gate sends the shape, as at 384 px; plain attention at 224 px);
      ``1`` keeps a forward-only fused request
      (``use_fused_block`` without ``use_fused_block_bwd``: kernel K4, the
      gradient by autograd through a recompute of the plain block); unset,
      a forward-only request is turned off, and with `default_fused_bwd`
      (every trainer but retrieval) a config that asks for nothing gets the
      fused pair, K4 forward and K5 backward.

    The fused schedule self-gates in `vit_forward`: it runs on the card at
    a width that is a multiple of 128, so off the card (or at the 32-wide
    test sizes) the same config trains on the classic schedule.
    """
    if med_remat and not med_cfg.remat:
        med_cfg = dataclasses.replace(med_cfg, remat=True)
    if vit_cfg.use_fused_mlp:
        vit_cfg = dataclasses.replace(vit_cfg, use_fused_mlp=False)
    if med_cfg.use_fused_mlp:
        med_cfg = dataclasses.replace(med_cfg, use_fused_mlp=False)
    fused_env = os.environ.get("VIDIL_TPU_TRAIN_FUSED_BLOCK")
    if fused_env == "0":
        vit_cfg = dataclasses.replace(vit_cfg, use_fused_block=False, use_fused_block_bwd=False)
    elif vit_cfg.use_fused_block and not vit_cfg.use_fused_block_bwd and fused_env != "1":
        vit_cfg = dataclasses.replace(vit_cfg, use_fused_block=False)
    elif not vit_cfg.use_fused_block and default_fused_bwd:
        vit_cfg = dataclasses.replace(vit_cfg, use_fused_block=True, use_fused_block_bwd=True)
    return vit_cfg, med_cfg


def model_cfgs(config: dict, med_json: str = "med_config.json"):
    """(vit_cfg, med_cfg) of a trainer's yaml: ``vit_config`` (custom sizes)
    or ``vit`` base/large with ``vit_grad_ckpt`` as the ViT remat; MED from
    ``med_config`` or the repo's ``configs/<med_json>``, its cross-attention
    as wide as the ViT."""
    from vidil_tpu_torch.config import MedConfig, ViTConfig

    if "vit_config" in config:
        vit_cfg = ViTConfig(image_size=config["image_size"], **config["vit_config"])
    else:
        vit_cfg = ViTConfig.from_name(config["vit"], config["image_size"],
                                      remat=config.get("vit_grad_ckpt", False))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    med_path = config.get("med_config", os.path.join(repo, "configs", med_json))
    return vit_cfg, MedConfig.from_json(med_path, encoder_width=vit_cfg.hidden_size)


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


def loader_shards(n_items: int | None = None) -> dict:
    """`PrefetchLoader` keywords of this rank over the world of ranks:
    its rows of each global train batch (no `n_items`), or its
    `shard_range` of an eval set of `n_items`. Empty on one rank."""
    from vidil_tpu_torch.utils.dist import get_rank, get_world_size
    from vidil_tpu_torch.utils.io import shard_range

    world = get_world_size()
    if world == 1:
        return {}
    if n_items is None:
        return {"rank_rows": (get_rank(), world)}
    return {"item_range": shard_range(n_items)}


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


@dataclass
class TrainState:
    params: dict  # port tree of fp32 leaves that require grad
    optimizer: torch.optim.Optimizer
    device: torch.device
    step: int = 0


def create_train_state(params, init_lr: float, weight_decay: float = 0.05,
                       device="cuda") -> TrainState:
    """Copy `params` to `device` as fp32 leaves that require grad (the
    caller's tensors are left as they are), and build the AdamW optimizer
    over them. CUDA unless the caller asks for the CPU; raises when CUDA is
    asked for and missing."""
    from vidil_tpu_torch.pipeline.capfilt import resolve_device

    device = resolve_device(device)

    def leaf(t):
        if t.dtype != torch.float32:
            raise TypeError(f"master parameters must be fp32, got {t.dtype}")
        return t.detach().to(device, copy=True).requires_grad_(True)

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return leaf(node)

    params = copy(params)
    return TrainState(params, make_optimizer(params, init_lr, weight_decay), device)


def apply_gradients(state: TrainState, loss, data_parallel: bool = False) -> TrainState:
    """Backward of `loss` into fresh ``.grad`` and one AdamW step, in place;
    the parameters' ``.grad`` keep this step's gradients.

    data_parallel: `loss` is this rank's share of the global batch's loss
    (the shares sum to it), so the gradients are summed over the ranks
    (`all_reduce_grads`, bucketed) before the step: every rank then takes
    the one-process global-batch step."""
    from vidil_tpu_torch.parallel.collectives import all_reduce_grads

    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if data_parallel:
        all_reduce_grads([p for _, p in named_leaves(state.params)])
    state.optimizer.step()
    state.step += 1
    return state
