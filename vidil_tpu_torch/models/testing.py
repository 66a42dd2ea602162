"""Random torch-style state dicts with the reference's key names: test and
bench fixtures (random weights) so the converter and CLI paths run
offline. The port's own copy of ``vidil_tpu/models/testing.py``."""

from __future__ import annotations

import numpy as np

from vidil_tpu_torch.config import MedConfig, ViTConfig


def make_vit_sd(cfg: ViTConfig, rng, prefix: str = "visual_encoder.") -> dict:
    d = cfg.hidden_size
    t = lambda *s: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05)
    sd = {
        prefix + "patch_embed.proj.weight": t(d, cfg.in_channels, cfg.patch_size, cfg.patch_size),
        prefix + "patch_embed.proj.bias": t(d),
        prefix + "cls_token": t(1, 1, d),
        prefix + "pos_embed": t(1, cfg.seq_len, d),
        prefix + "norm.weight": 1 + 0.1 * t(d),
        prefix + "norm.bias": 0.1 * t(d),
    }
    for i in range(cfg.num_layers):
        b = f"{prefix}blocks.{i}."
        h = int(d * cfg.mlp_ratio)
        sd.update({
            b + "norm1.weight": 1 + 0.1 * t(d), b + "norm1.bias": 0.1 * t(d),
            b + "attn.qkv.weight": t(3 * d, d), b + "attn.qkv.bias": t(3 * d),
            b + "attn.proj.weight": t(d, d), b + "attn.proj.bias": t(d),
            b + "norm2.weight": 1 + 0.1 * t(d), b + "norm2.bias": 0.1 * t(d),
            b + "mlp.fc1.weight": t(h, d), b + "mlp.fc1.bias": t(h),
            b + "mlp.fc2.weight": t(d, h), b + "mlp.fc2.bias": t(d),
        })
    return sd


def make_med_sd(
    cfg: MedConfig,
    rng,
    prefix: str = "",
    lm_head_prefix: str | None = None,
    cross: bool = True,
) -> dict:
    d = cfg.hidden_size
    t = lambda *s: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05)
    word = t(cfg.vocab_size, d)
    sd = {
        prefix + "embeddings.word_embeddings.weight": word,
        prefix + "embeddings.position_embeddings.weight": t(cfg.max_position_embeddings, d),
        prefix + "embeddings.LayerNorm.weight": 1 + 0.1 * t(d),
        prefix + "embeddings.LayerNorm.bias": 0.1 * t(d),
    }
    for i in range(cfg.num_layers):
        b = f"{prefix}encoder.layer.{i}."
        sd.update({
            b + "attention.self.query.weight": t(d, d), b + "attention.self.query.bias": t(d),
            b + "attention.self.key.weight": t(d, d), b + "attention.self.key.bias": t(d),
            b + "attention.self.value.weight": t(d, d), b + "attention.self.value.bias": t(d),
            b + "attention.output.dense.weight": t(d, d), b + "attention.output.dense.bias": t(d),
            b + "attention.output.LayerNorm.weight": 1 + 0.1 * t(d),
            b + "attention.output.LayerNorm.bias": 0.1 * t(d),
            b + "intermediate.dense.weight": t(cfg.intermediate_size, d),
            b + "intermediate.dense.bias": t(cfg.intermediate_size),
            b + "output.dense.weight": t(d, cfg.intermediate_size), b + "output.dense.bias": t(d),
            b + "output.LayerNorm.weight": 1 + 0.1 * t(d), b + "output.LayerNorm.bias": 0.1 * t(d),
        })
        if cross:
            sd.update({
                b + "crossattention.self.query.weight": t(d, d), b + "crossattention.self.query.bias": t(d),
                b + "crossattention.self.key.weight": t(d, cfg.encoder_width),
                b + "crossattention.self.key.bias": t(d),
                b + "crossattention.self.value.weight": t(d, cfg.encoder_width),
                b + "crossattention.self.value.bias": t(d),
                b + "crossattention.output.dense.weight": t(d, d),
                b + "crossattention.output.dense.bias": t(d),
                b + "crossattention.output.LayerNorm.weight": 1 + 0.1 * t(d),
                b + "crossattention.output.LayerNorm.bias": 0.1 * t(d),
            })
    if lm_head_prefix is not None:
        h = lm_head_prefix
        sd.update({
            h + "cls.predictions.transform.dense.weight": t(d, d),
            h + "cls.predictions.transform.dense.bias": t(d),
            h + "cls.predictions.transform.LayerNorm.weight": 1 + 0.1 * t(d),
            h + "cls.predictions.transform.LayerNorm.bias": 0.1 * t(d),
            h + "cls.predictions.bias": t(cfg.vocab_size),
            h + "cls.predictions.decoder.weight": word,  # tied
        })
    return sd


def make_blip_decoder_ckpt(vit_cfg, med_cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    sd = make_vit_sd(vit_cfg, rng)
    sd.update(make_med_sd(med_cfg, rng, prefix="text_decoder.bert.", lm_head_prefix="text_decoder."))
    return sd


def make_blip_itm_ckpt(vit_cfg, med_cfg, embed_dim=32, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    sd = make_vit_sd(vit_cfg, rng)
    sd.update(make_med_sd(med_cfg, rng, prefix="text_encoder."))
    d = med_cfg.hidden_size
    t = lambda *s: rng.standard_normal(s, dtype=np.float32) * np.float32(0.05)
    sd.update({
        "vision_proj.weight": t(embed_dim, vit_cfg.hidden_size), "vision_proj.bias": t(embed_dim),
        "text_proj.weight": t(embed_dim, d), "text_proj.bias": t(embed_dim),
        "itm_head.weight": t(2, d), "itm_head.bias": t(2),
    })
    return sd


def save_torch_ckpt(sd: dict, path: str) -> None:
    import torch

    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, path)
