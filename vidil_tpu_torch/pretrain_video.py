"""BLIP video pretraining (ITA + ITM + LM) on the GPU — the port's CLI.

    python -m vidil_tpu_torch.pretrain_video --config CONFIG.yaml --output_dir OUT [--device cuda]

The same argparse and yaml surface as the root ``pretrain_video.py`` and
the same loop: a linear warmup over ``warmup_steps`` steps, then the
per-epoch step decay; alpha ramped over the first 2 epochs; captions
tokenized at max_length 30 with [ENC] (ITM) and [DEC] (LM) at position 0;
the triple loss with momentum towers, queues and the tied decoder
(`train/pretrain.py`). Each epoch writes ``checkpoint_NN.npz`` (params, the
JAX package's npz layout), ``checkpoint_last.npz`` (the full train state, in
the JAX package's leaf layout; ``resume:`` restores it) and a ``log.txt``
line. The towers compute in bf16 over fp32 master parameters; on the card
the ViT runs the fused block pair (opt out with
``VIDIL_TPU_TRAIN_FUSED_BLOCK=0``).

The weights are synthetic (`utils/synth.py`; the JAX CLI initialises from a
random key). The MED vocabulary is widened to the tokenizer's when the
config's is smaller (bert_config.json has 30522 words; [DEC] and [ENC] are
30522 and 30523), as the reference's resize_token_embeddings does. The
batch is the reference's ``batch_size`` (8 when unset); a
``batch_size_tpu`` key is reported and ignored. Not ported yet (they raise
NotImplementedError): the SPMD mesh keys, multi-process launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch


def build(config):
    """(vit_cfg, med_cfg, tokenizer)."""
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.train.common import model_cfgs

    vit_cfg, med_cfg = model_cfgs(config, "bert_config.json")
    tokenizer = BlipTokenizer(config["bert_vocab"])
    if tokenizer.vocab_size > med_cfg.vocab_size:
        med_cfg = dataclasses.replace(med_cfg, vocab_size=tokenizer.vocab_size)
    return vit_cfg, med_cfg, tokenizer


def tokenize(tokenizer, captions, max_length=30):
    """{text_ids, enc_ids, dec_ids, text_mask}: [CLS], [ENC] and [DEC] first."""
    enc = tokenizer(captions, padding="max_length", truncation=True, max_length=max_length)
    enc_ids = enc.input_ids.copy()
    enc_ids[:, 0] = tokenizer.enc_token_id
    dec_ids = enc.input_ids.copy()
    dec_ids[:, 0] = tokenizer.bos_token_id
    return {"text_ids": enc.input_ids, "enc_ids": enc_ids, "dec_ids": dec_ids,
            "text_mask": enc.attention_mask}


def main(args, config):
    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.datasets import PrefetchLoader, RetrievalTrainDataset
    from vidil_tpu_torch.models.blip_pretrain import init_pretrain_params
    from vidil_tpu_torch.pipeline.capfilt import resolve_device
    from vidil_tpu_torch.train.common import refuse_mesh_keys, resolve_train_batch, set_lr
    from vidil_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint, save_train_state
    from vidil_tpu_torch.utils.logging import MetricLogger
    from vidil_tpu_torch.utils.schedules import step_lr_schedule, warmup_lr_schedule
    from vidil_tpu_torch.utils.seeding import make_generator

    device = resolve_device(getattr(args, "device", "cuda"))
    refuse_mesh_keys(config)
    utils.init_distributed_mode(args)
    utils.seed_everything(args.seed)

    vit_cfg, med_cfg, tokenizer = build(config)
    dataset = RetrievalTrainDataset(dict(config), max_words=config.get("max_words", 30))
    B = resolve_train_batch(config, "batch_size", 8)
    loader = PrefetchLoader(dataset, B, shuffle=True, drop_last=True, seed=args.seed)

    queue_size = config.get("queue_size", 57600)
    queue_size -= queue_size % B
    state = create_pretrain_state(init_pretrain_params(vit_cfg, med_cfg), config["init_lr"],
                                  config.get("weight_decay", 0.05), queue_size=queue_size,
                                  seed=args.seed, device=device)
    step_fn = make_pretrain_step(vit_cfg, med_cfg, dtype=torch.bfloat16)

    start_epoch = 0
    resume_path = config.get("resume", "")
    if resume_path:
        state, ck_meta = load_train_state(resume_path, state)
        start_epoch = (ck_meta or {}).get("epoch", -1) + 1
        print(f"resumed full train state from {resume_path} at epoch {start_epoch}")

    warmup_steps = config.get("warmup_steps", 3000)
    n_per_epoch = len(loader)
    for epoch in range(start_epoch, config["max_epoch"]):
        loader.set_epoch(epoch)
        logger = MetricLogger(delimiter="  ")
        for i, (video, captions, _) in enumerate(
                logger.log_every(loader, 50, f"Pretrain epoch {epoch}")):
            step_idx = epoch * n_per_epoch + i
            if step_idx < warmup_steps:
                lr = warmup_lr_schedule(step_idx, warmup_steps, config.get("warmup_lr", 1e-6),
                                        config["init_lr"])
            else:
                lr = step_lr_schedule(epoch, config["init_lr"], config.get("min_lr", 1e-6),
                                      config.get("lr_decay_rate", 0.9))
            set_lr(state.optimizer, lr)
            # alpha ramp over the first 2 epochs (reference :108)
            alpha = config["alpha"] * min(1.0, step_idx / (2 * n_per_epoch))
            batch = {"video": np.asarray(video), **tokenize(tokenizer, list(captions))}
            state, metrics = step_fn(state, batch, alpha,
                                     make_generator(args.seed, step_idx, device))
            logger.update(loss_ita=float(metrics["loss_ita"]),
                          loss_itm=float(metrics["loss_itm"]),
                          loss_lm=float(metrics["loss_lm"]), lr=lr)
        if utils.is_main_process():
            save_checkpoint(os.path.join(args.output_dir, f"checkpoint_{epoch:02d}"),
                            state.params, meta={"epoch": epoch})
            save_train_state(os.path.join(args.output_dir, "checkpoint_last"), state,
                             meta={"epoch": epoch})
            with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
                stats = {k: m.global_avg for k, m in logger.meters.items()}
                f.write(json.dumps({**stats, "epoch": epoch}) + "\n")
        utils.barrier()
    return state


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/pretrain_video.yaml")
    parser.add_argument("--output_dir", default="output/pretrain_video")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--dist_url", default="env://")
    parser.add_argument("--distributed", default=True, type=bool)
    return parser.parse_args(argv)


if __name__ == "__main__":
    import yaml

    args = parse_args()
    with open(args.config) as f:
        config = yaml.safe_load(f)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    main(args, config)
