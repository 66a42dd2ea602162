"""Model architecture configs and the pipeline-yaml helpers
(`load_yaml_config`, `dump_yaml_config`, `asdict`).

The port's own copy of the JAX package's ``ViTConfig`` / ``MedConfig``
fields (same defaults, same ``from_json`` mapping of a BERT/MED json),
with the training fields the trainers read (remat, label smoothing) and
the fused ViT block's switches (kernels K4/K5, `models/vit.py`) and the
fused MLP switch (kernel K3, `models/layers.py:mlp_auto`), and the JAX
package's ``CLIPConfig``. ``remat_policy`` names the remat's saving rule
(`models/layers.py:remat_policy`: None or "dots"); another name fails at
construction.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import torch

from vidil_tpu_torch.models.layers import remat_policy


def load_yaml_config(path: str) -> dict:
    """A pipeline or trainer yaml (PyYAML, imported here: the port's models
    do not need it)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def dump_yaml_config(config: dict, out_dir: str, name: str = "config.yaml",
                     sort_keys: bool = False) -> None:
    """Echo the resolved config into the output dir for provenance
    (reference: run_video_CapFilt.py:304-308), keys in their order; the
    CLIs pass ``sort_keys=True``, the root CLIs' echo (PyYAML's default)."""
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        yaml.safe_dump(config, f, sort_keys=sort_keys)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


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


def _check_remat_policy(cfg) -> None:
    """Raise ValueError for a remat policy the port does not know."""
    remat_policy(cfg.remat_policy)


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
    remat_policy: str | None = None  # None = recompute the whole block; "dots"
    # the self-attention through `attention_auto`'s gate (kernel K1 where the
    # reference's `_flash_profitable` holds); False = plain attention at
    # every shape, as the JAX package's `use_flash=False`
    use_flash: bool = True
    use_fused_mlp: bool = False  # the MLP as kernel K3 (models/layers.py:mlp_auto)
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
        _check_remat_policy(self)

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
    remat_policy: str | None = None  # None = recompute the whole layer; "dots"
    use_fused_mlp: bool = False  # the FFN as kernel K3 (models/layers.py:mlp_auto)

    def __post_init__(self):
        _check_remat_policy(self)

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


@dataclass(frozen=True)
class CLIPConfig:
    """OpenAI CLIP dual towers (ViT-L/14 defaults; HF clip-vit-large-patch14)."""

    # vision tower
    image_size: int = 224
    patch_size: int = 14
    vision_hidden_size: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_intermediate_size: int = 4096
    # text tower
    vocab_size: int = 49408
    text_hidden_size: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate_size: int = 3072
    max_text_len: int = 77
    # shared
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @classmethod
    def vit_b_32(cls) -> "CLIPConfig":
        return cls(
            patch_size=32, vision_hidden_size=768, vision_layers=12, vision_heads=12,
            vision_intermediate_size=3072, text_hidden_size=512, text_heads=8,
            text_intermediate_size=2048, projection_dim=512,
        )

    @classmethod
    def vit_l_14(cls) -> "CLIPConfig":
        return cls()


@dataclass(frozen=True)
class NemotronHConfig:
    """A Nemotron-H hybrid decoder (`models/nemotron_h.py`), under the keys
    of its Hugging Face ``config.json`` (``model_type`` ``nemotron_h``);
    the defaults are NVIDIA-Nemotron-3-Nano-30B-A3B's. Each character of
    ``hybrid_override_pattern`` is one layer: ``M`` a Mamba-2 mixer, ``E``
    a mixture of experts, ``*`` attention."""

    vocab_size: int = 131072
    hidden_size: int = 2688
    hybrid_override_pattern: str = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
    norm_eps: float = 1e-5
    # Mamba-2
    mamba_num_heads: int = 64
    mamba_head_dim: int = 64
    ssm_state_size: int = 128
    n_groups: int = 8
    conv_kernel: int = 4
    chunk_size: int = 128
    time_step_min: float = 0.001
    time_step_max: float = 0.1
    time_step_floor: float = 1e-4
    # attention
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    head_dim: int = 128
    # mixture of experts
    n_routed_experts: int = 128
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1856
    moe_shared_expert_intermediate_size: int = 3712
    routed_scaling_factor: float = 2.5
    norm_topk_prob: bool = True

    def __post_init__(self):
        if set(self.hybrid_override_pattern) - set("ME*"):
            raise ValueError(f"unknown layer kinds in {self.hybrid_override_pattern!r}")
        if self.mamba_inner % self.n_groups or self.mamba_num_heads % self.n_groups:
            raise ValueError("the Mamba heads and width must split into n_groups groups")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("query heads must be a multiple of the key/value heads")

    @classmethod
    def from_dict(cls, d: dict) -> "NemotronHConfig":
        """The fields of a ``config.json``-shaped dict; other keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def mamba_inner(self) -> int:
        return self.mamba_num_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        """The convolved channels: x, then B and C of every group."""
        return self.mamba_inner + 2 * self.n_groups * self.ssm_state_size

    @property
    def in_proj_size(self) -> int:
        """in_proj's outputs: the gate z, the convolved xBC, dt."""
        return self.mamba_inner + self.conv_dim + self.mamba_num_heads
