"""BLIP video retrieval fine-tuning on the GPU — the port's CLI.

    python -m vidil_tpu_torch.train_retrieval_video --config CONFIG.yaml --output_dir OUT [--evaluate] [--device cuda]

The same argparse and yaml surface as the root ``train_retrieval_video.py``
and the same loop: ITA + ITM training on (pseudo-)labelled caption jsonl
with momentum towers and feature queues, a per-epoch cosine LR, alpha
ramped over epoch 0, then each epoch the k_test ITM-reranked retrieval eval
of the val and test splits (`evals/retrieval.py`), ``checkpoint_best.npz``
gated on val r_mean (in the JAX package's npz layout, so its
`load_checkpoint` reads it), ``checkpoint_last.npz`` (the full train state,
in the JAX package's leaf layout: its `load_train_state` reads it too, and
``resume:`` restores it here) and ``log.txt`` / ``evaluate.txt`` json
lines. The towers compute in bf16 over fp32 master parameters.

Config keys beyond the reference's: bert_vocab, optional vit_config /
med_config for custom sizes; without ``pretrained`` the weights are
synthetic (`utils/synth.py`). The batch is the reference's
``batch_size_train``; a ``batch_size_train_tpu`` key is reported and
ignored. Hard negatives come from ``make_generator(seed, step)``
(`utils/seeding.py`), not JAX's key stream. Not ported yet (they raise
NotImplementedError): the SPMD mesh keys (data_parallel, model_parallel,
optimizer_sharding), multi-process launches.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch


def build(config):
    """(params (port tree, CPU), tokenizer, vit_cfg, med_cfg)."""
    from vidil_tpu_torch.models import convert
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.train.common import model_cfgs

    vit_cfg, med_cfg = model_cfgs(config)
    tokenizer = BlipTokenizer(config["bert_vocab"])
    pretrained = config.get("pretrained", "")
    if pretrained:
        sd = convert.load_torch_state_dict(pretrained)
        params = convert.convert_blip_retrieval(sd, vit_cfg, med_cfg, with_momentum=False)
    else:
        from vidil_tpu_torch.models.blip import blip_retrieval_shapes
        from vidil_tpu_torch.utils.synth import synth_tree

        params = convert.from_jax_params(
            synth_tree(blip_retrieval_shapes(vit_cfg, med_cfg), "cpu", salt=2.0))
        del params["temp"]  # create_train_state sets 0.07
    return params, tokenizer, vit_cfg, med_cfg


def tokenize(tokenizer, captions, max_length=35):
    """(ids, enc_ids, mask): [CLS]-prefixed ids, the same with [ENC] first."""
    enc = tokenizer(captions, padding="max_length", truncation=True, max_length=max_length)
    enc_ids = enc.input_ids.copy()
    enc_ids[:, 0] = tokenizer.enc_token_id
    return enc.input_ids, enc_ids, enc.attention_mask


def run_eval(params, dataset, tokenizer, vit_cfg, med_cfg, config, dtype=torch.bfloat16):
    """The retrieval metrics (`itm_eval`) of one split."""
    from vidil_tpu_torch.data.datasets import PrefetchLoader
    from vidil_tpu_torch.evals.retrieval import RetrievalEvaluator, itm_eval

    evaluator = RetrievalEvaluator(params, vit_cfg, med_cfg, tokenizer, k_test=config["k_test"],
                                   dtype=dtype)
    text_embeds, text_ids, text_atts = evaluator.compute_text_features(dataset.text)
    loader = PrefetchLoader(dataset, config["batch_size_test"])
    video_feats, video_embeds = evaluator.compute_video_features(video for video, _ in loader)
    v2t, t2v = evaluator.score_matrices(video_feats, video_embeds, text_embeds, text_ids,
                                        text_atts)
    return itm_eval(v2t, t2v, dataset.txt2video, dataset.video2txt)


def main(args, config):
    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.datasets import (
        PrefetchLoader,
        RetrievalEvalDataset,
        RetrievalTrainDataset,
    )
    from vidil_tpu_torch.pipeline.capfilt import resolve_device
    from vidil_tpu_torch.train.common import refuse_mesh_keys, resolve_train_batch, set_lr
    from vidil_tpu_torch.train.retrieval import create_train_state, make_retrieval_train_step
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint, save_train_state
    from vidil_tpu_torch.utils.logging import MetricLogger
    from vidil_tpu_torch.utils.schedules import cosine_lr_schedule
    from vidil_tpu_torch.utils.seeding import make_generator

    device = resolve_device(getattr(args, "device", "cuda"))
    refuse_mesh_keys(config)
    utils.init_distributed_mode(args)
    utils.seed_everything(args.seed)
    dtype = torch.bfloat16

    params, tokenizer, vit_cfg, med_cfg = build(config)

    ds_cfg = dict(config)
    ds_cfg.setdefault("num_frm_train", 4)
    train_dataset = RetrievalTrainDataset(ds_cfg)
    eval_root = config.get("eval_video_root", config.get("video_root"))

    def eval_dataset(ann_key):
        return RetrievalEvalDataset(eval_root, config[ann_key], num_frm=config["num_frm_test"],
                                    frm_sampling_strategy="uniform",
                                    max_img_size=config["image_size"])

    val_dataset, test_dataset = eval_dataset("val_ann_jsonl"), eval_dataset("test_ann_jsonl")

    B = resolve_train_batch(config, "batch_size_train")
    train_loader = PrefetchLoader(train_dataset, B, shuffle=True, drop_last=True, seed=args.seed)
    # the queue must be a multiple of the batch (reference :546)
    queue_size = config["queue_size"] - config["queue_size"] % B
    state = create_train_state(params, config["init_lr"], config.get("weight_decay", 0.05),
                               embed_dim=params["vision_proj"]["kernel"].shape[1],
                               queue_size=queue_size, seed=args.seed, device=device)
    del params
    train_step = make_retrieval_train_step(vit_cfg, med_cfg, dtype=dtype)

    # full-state resume: params, AdamW moments, momentum towers, queues
    start_epoch = 0
    resume_path = config.get("resume", "")
    if resume_path and not args.evaluate:
        state, ck_meta = load_train_state(resume_path, state)
        start_epoch = (ck_meta or {}).get("epoch", -1) + 1
        print(f"resumed full train state from {resume_path} at epoch {start_epoch}")

    def evaluate(dataset):
        return run_eval(state.params, dataset, tokenizer, vit_cfg, med_cfg, config, dtype)

    best, best_epoch = 0.0, 0
    n_steps_per_epoch = len(train_loader)
    for epoch in range(start_epoch, config["max_epoch"]):
        if not args.evaluate:
            train_loader.set_epoch(epoch)
            lr = cosine_lr_schedule(epoch, config["max_epoch"], config["init_lr"],
                                    config.get("min_lr", 0))
            set_lr(state.optimizer, lr)
            logger = MetricLogger(delimiter="  ")
            for i, (video, captions, idx) in enumerate(
                    logger.log_every(train_loader, 50, f"Train epoch {epoch}")):
                # alpha ramp over epoch 0 (reference :55-59)
                alpha = config["alpha"] * (1.0 if epoch > 0 else min(1.0, i / n_steps_per_epoch))
                ids, enc_ids, mask = tokenize(tokenizer, list(captions))
                batch = {"video": np.asarray(video), "text_ids": ids, "enc_ids": enc_ids,
                         "text_mask": mask, "idx": np.asarray(idx)}
                state, metrics = train_step(state, batch, alpha,
                                            make_generator(args.seed, state.step, device))
                logger.update(loss_ita=float(metrics["loss_ita"]),
                              loss_itm=float(metrics["loss_itm"]), lr=lr)

        val_metrics = evaluate(val_dataset)
        print("val:", val_metrics)
        test_metrics = evaluate(test_dataset)
        print("test:", test_metrics)
        if utils.is_main_process():
            log_stats = {**{f"val_{k}": v for k, v in val_metrics.items()},
                         **{f"test_{k}": v for k, v in test_metrics.items()}, "epoch": epoch}
            if not args.evaluate and val_metrics["r_mean"] > best:
                best = val_metrics["r_mean"]
                best_epoch = epoch
                save_checkpoint(os.path.join(args.output_dir, "checkpoint_best"), state.params,
                                meta={"epoch": epoch})
            log_stats["best_epoch"] = best_epoch
            name = "evaluate.txt" if args.evaluate else "log.txt"
            with open(os.path.join(args.output_dir, name), "a") as f:
                f.write(json.dumps(log_stats) + "\n")
            if not args.evaluate:
                save_train_state(os.path.join(args.output_dir, "checkpoint_last"), state,
                                 meta={"epoch": epoch})
        if args.evaluate:
            break
        utils.barrier()
    return state


def parse_args(argv=None, evaluate_flag: bool = True,
               default_output: str = "output/retrieval_video"):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/train_blip_video_retrieval_msrvtt_pseudo.yaml")
    parser.add_argument("--output_dir", default=default_output)
    if evaluate_flag:
        parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--dist_url", default="env://")
    parser.add_argument("--distributed", default=True, type=bool)
    args = parser.parse_args(argv)
    if not evaluate_flag:
        args.evaluate = True
    return args


def run_cli(args):
    """Read the yaml, write it into the output dir, run `main`."""
    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    return main(args, config)


if __name__ == "__main__":
    run_cli(parse_args())
