"""Model architecture configs and the pipeline-yaml helpers.

The port's own copy of the JAX package's ``ViTConfig`` / ``MedConfig``
fields (same defaults, same ``from_json`` mapping of a BERT/MED json),
with the training fields the trainers read (remat, label smoothing) and
the fused ViT block's switches (kernels K4/K5, `models/vit.py`). The fused
MLP switch (kernel K3, not ported yet) and ``remat_policy="dots"`` are
fields too, but a config that turns one on fails at construction with
NotImplementedError instead of running another path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, fields

import torch

from vidil_tpu_torch.models.layers import remat_policy


def compute_dtype_from_config(config: dict, override=None) -> torch.dtype:
    """Tower compute dtype for the pipeline CLIs: bf16 by default (bf16
    matmuls with fp32 LayerNorm/softmax islands inside the models);
    `compute_dtype: float32` runs the towers in full fp32. A non-None
    `override` (a torch dtype) wins over the config."""
    if override is not None:
        return override
    name = config.get("compute_dtype", "bfloat16")
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in table:
        raise ValueError(
            f"compute_dtype: {name!r} — expected one of {sorted(table)}")
    return table[name]


def _refuse_unported(cfg, switches) -> None:
    """Raise for every TPU-only field of `switches` that `cfg` sets away from
    its default, and for a remat policy other than None (full recompute)."""
    on = [f.name for f in fields(cfg) if f.name in switches and getattr(cfg, f.name) != f.default]
    if on:
        raise NotImplementedError(
            f"vidil_tpu_torch: {', '.join(on)} (TPU kernels of the JAX package) "
            "are not ported yet")
    remat_policy(cfg.remat_policy)


_VIT_TPU_SWITCHES = ("use_fused_mlp",)
_MED_TPU_SWITCHES = ("use_fused_mlp",)


@dataclass(frozen=True)
class ViTConfig:
    """BLIP vision transformer. base: 768d/12L/12H, large: 1024d/24L/16H;
    patch 16, pre-LN, GELU."""

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    in_channels: int = 3
    remat: bool = False  # torch.utils.checkpoint on blocks >= remat_from_layer
    remat_from_layer: int = 0
    remat_policy: str | None = None  # None = recompute the whole block
    use_fused_mlp: bool = False  # kernel K3 of the JAX package: accepted only when off
    # The fused-block schedule: each block as kernel K4 (`use_fused_block`),
    # its gradient as kernel K5 (`use_fused_block_bwd`, which is its own
    # remat; otherwise autograd through a recompute of the plain block). It
    # runs on CUDA tensors at a width that is a multiple of 128, or on the
    # CPU through the kernels' plain twins with `fused_block_interpret`.
    # The trainers turn the pair on (train/common.py:training_cfgs).
    use_fused_block: bool = False
    # frames per program of the TPU kernels' grid; the Hopper kernels choose
    # their own tiling, and results do not depend on these two
    fused_block_frames: int = 8
    use_fused_block_bwd: bool = False
    fused_block_bwd_frames: int = 1
    fused_block_interpret: bool = False

    def __post_init__(self):
        _refuse_unported(self, _VIT_TPU_SWITCHES)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]

    @classmethod
    def from_name(cls, vit: str, image_size: int, **kw) -> "ViTConfig":
        if vit == "base":
            return cls(image_size=image_size, hidden_size=768, num_layers=12, num_heads=12, **kw)
        if vit == "large":
            return cls(image_size=image_size, hidden_size=1024, num_layers=24, num_heads=16, **kw)
        raise ValueError(f"unknown vit size: {vit}")


@dataclass(frozen=True)
class MedConfig:
    """MED — BERT with optional cross-attention + causal LM
    (configs/med_config.json)."""

    vocab_size: int = 30524
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    encoder_width: int = 768
    add_cross_attention: bool = True
    pad_token_id: int = 0
    hidden_act: str = "gelu"
    label_smoothing: float = 0.1
    remat: bool = False  # torch.utils.checkpoint on every layer
    remat_policy: str | None = None  # None = recompute the whole layer
    use_fused_mlp: bool = False  # TPU kernel switch: accepted only when off

    def __post_init__(self):
        _refuse_unported(self, _MED_TPU_SWITCHES)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "MedConfig":
        with open(path) as f:
            raw = json.load(f)
        mapped = dict(
            vocab_size=raw.get("vocab_size", 30524),
            hidden_size=raw.get("hidden_size", 768),
            num_layers=raw.get("num_hidden_layers", 12),
            num_heads=raw.get("num_attention_heads", 12),
            intermediate_size=raw.get("intermediate_size", 3072),
            max_position_embeddings=raw.get("max_position_embeddings", 512),
            layer_norm_eps=raw.get("layer_norm_eps", 1e-12),
            encoder_width=raw.get("encoder_width", 768),
            add_cross_attention=raw.get("add_cross_attention", True),
            pad_token_id=raw.get("pad_token_id", 0),
            hidden_act=raw.get("hidden_act", "gelu"),
        )
        mapped.update(overrides)
        return cls(**mapped)
