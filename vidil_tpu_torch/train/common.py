"""Shared trainer setup: config normalisation, batch size, optimizer and
the train state of the caption and VQA trainers.

Counterpart of ``vidil_tpu/train/common.py`` (`training_cfgs`,
`resolve_train_batch`) and of ``vidil_tpu/train/retrieval.py:make_optimizer``.

The (data, model) grid (`parallel/mesh.py:Grid`, carried by the train
state): each data rank's step takes its rows of the global batch and
computes its share of the global batch's loss (a mean over the global
batch's tokens or rows, whose counts come from an all-reduce over the data
group); the gradients are summed over the data group before AdamW
(`apply_gradients`), so every rank takes the one-process global-batch
step. Under a model axis the state holds this rank's shards of the
parameters (`parallel/sharding.py:shard_params`), the towers run
tensor-parallel, and every model rank computes the same global loss.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from vidil_tpu_torch.models.convert import named_leaves


def training_cfgs(vit_cfg, med_cfg, med_remat: bool = True, default_fused_bwd: bool = True,
                  model_parallel: int = 1):
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

    Under ``model_parallel > 1`` the towers' heads and widths must divide
    the model axis (ValueError); the schedule is chosen as above, with no
    model-axis branch, as in the JAX package: a fused block runs whole on
    every model rank (`vit_forward`).
    """
    if med_remat and not med_cfg.remat:
        med_cfg = dataclasses.replace(med_cfg, remat=True)
    if vit_cfg.use_fused_mlp:
        vit_cfg = dataclasses.replace(vit_cfg, use_fused_mlp=False)
    if med_cfg.use_fused_mlp:
        med_cfg = dataclasses.replace(med_cfg, use_fused_mlp=False)
    if model_parallel > 1:
        widths = {"vit num_heads": vit_cfg.num_heads, "vit hidden_size": vit_cfg.hidden_size,
                  "vit mlp width": int(vit_cfg.hidden_size * vit_cfg.mlp_ratio),
                  "med num_heads": med_cfg.num_heads, "med hidden_size": med_cfg.hidden_size,
                  "med intermediate_size": med_cfg.intermediate_size}
        bad = {k: v for k, v in widths.items() if v % model_parallel}
        if bad:
            raise ValueError(f"model_parallel {model_parallel} does not divide {bad}")
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


def loader_shards(n_items: int | None = None, grid=None) -> dict:
    """`PrefetchLoader` keywords of this rank: its rows of each global train
    batch over the grid's data axis (no `n_items`; `grid` default: the
    world's), or its `shard_range` of an eval set of `n_items` over the
    whole world. Empty on one rank."""
    from vidil_tpu_torch.utils.dist import get_rank, get_world_size
    from vidil_tpu_torch.utils.io import shard_range

    world = get_world_size()
    if world == 1:
        return {}
    if n_items is None:
        if grid is not None and grid.data_group is not None:
            return {} if grid.data == 1 else {"rank_rows": (grid.data_rank, grid.data)}
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
    params: dict  # port tree of fp32 leaves that require grad (this rank's shards)
    optimizer: torch.optim.Optimizer
    device: torch.device
    step: int = 0
    grid: object = None  # parallel/mesh.py:Grid; None: the world's data axis


def step_grid(state):
    """The grid a step runs on: the state's, else the data axis over the
    world (`mesh.world_grid`: no collective without a process group)."""
    from vidil_tpu_torch.parallel.mesh import world_grid

    return state.grid if state.grid is not None else world_grid()


def create_train_state(params, init_lr: float, weight_decay: float = 0.05,
                       device="cuda", grid=None) -> TrainState:
    """Copy `params` to `device` as fp32 leaves that require grad (the
    caller's tensors are left as they are), and build the AdamW optimizer
    over them. CUDA unless the caller asks for the CPU; raises when CUDA is
    asked for and missing. Under `grid`'s model axis (a
    `parallel/mesh.py:Grid`) the state keeps this rank's shards
    (`shard_params`)."""
    from vidil_tpu_torch.parallel.sharding import shard_params
    from vidil_tpu_torch.pipeline.capfilt import resolve_device

    device = resolve_device(device)
    params = shard_params(params, grid)

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
    return TrainState(params, make_optimizer(params, init_lr, weight_decay), device, grid=grid)


def model_batch(tensors: dict, grid) -> dict:
    """The batch's tensors, under `grid`'s model axis those of the first
    model rank of this data rank (`broadcast_first`): every model rank
    computes its heads of the same rows, whatever augmentations its own
    loader drew."""
    from vidil_tpu_torch.parallel.collectives import broadcast_first

    if grid is None or not grid.tensor_parallel:
        return tensors
    return broadcast_first(tensors, grid.model_group)


def step_metrics(grid, **losses) -> dict:
    """The step's losses, detached; the global batch's (the data ranks'
    shares summed over the data group) under `grid`'s data axis."""
    from vidil_tpu_torch.parallel.collectives import psum

    if grid is None or not grid.data_parallel:
        return {k: v.detach() for k, v in losses.items()}
    return {k: psum(v, grid.data_group) for k, v in losses.items()}


def apply_gradients(state: TrainState, loss, grid=None) -> TrainState:
    """Backward of `loss` into fresh ``.grad`` and one AdamW step, in place;
    the parameters' ``.grad`` keep this step's gradients.

    grid (`parallel/mesh.py:Grid`): under its data axis `loss` is this
    rank's share of the global batch's loss (the shares sum to it), so the
    gradients are summed over the data group (`all_reduce_grads`,
    bucketed) before the step: every rank then takes the one-process
    global-batch step. Under its model axis the leaves it replicates first
    take the first model rank's gradient (`broadcast_grads`): the model
    ranks compute them alike, but a kernel's atomic adds may round them
    otherwise, and the replicas must stay equal."""
    from vidil_tpu_torch.parallel.collectives import all_reduce_grads, broadcast_grads
    from vidil_tpu_torch.parallel.sharding import replicated_leaves

    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if grid is not None and grid.tensor_parallel:
        broadcast_grads(replicated_leaves(state.params), grid.model_group)
    if grid is not None and grid.data_parallel:
        all_reduce_grads([p for _, p in named_leaves(state.params)], grid.data_group)
    state.optimizer.step()
    state.step += 1
    return state
