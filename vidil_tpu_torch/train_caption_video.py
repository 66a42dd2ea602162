"""BLIP video caption fine-tuning on the GPU — the port's CLI.

    python -m vidil_tpu_torch.train_caption_video --config CONFIG.yaml --output_dir OUT [--device cuda]

The same argparse and yaml surface as the root ``train_caption_video.py``
and the same loop: per-epoch cosine LR, last-epoch val/test caption eval,
``checkpoint_best.npz`` gated on val CIDEr + Bleu_4 (in the JAX package's
npz layout, so its `load_checkpoint` reads it), ``checkpoint_last.npz``
(the full train state, for ``resume:``), and ``log.txt`` /
``evaluate.txt`` json-line appends. The towers compute in bf16 over fp32
master parameters, as in the JAX trainer.

Config keys beyond the reference's: bert_vocab, optional vit_config /
med_config for custom sizes. The batch is the reference's
``train_batch_size``; a ``train_batch_size_tpu`` key is reported and
ignored.

Several GPUs: launch under ``torchrun --nproc_per_node=N``. Each rank
takes its rows of every global batch of ``train_batch_size`` (which N
must divide) and the gradients are summed over the ranks, so the step is
the one-process step at that batch; the val/test captions are split
across the ranks and merged by rank 0. ``data_parallel: N`` times ``model_parallel``
must be the launch's world; ``optimizer_sharding: zero1`` shards the AdamW
moments (ZeRO-1). ``model_parallel: M`` adds a model axis: the launch's world is a (data,
model) grid of ranks (torchrun ``--nproc_per_node`` = data x model), each
model rank holding its shard of the towers' heads and hidden columns
(`parallel/sharding.py`); the saved states hold whole leaves, and the
evaluation runs on the gathered weights, split over the whole world.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

def build_model_and_tokenizer(config, device="cpu"):
    """(params, tokenizer, vit_cfg, med_cfg): the ``pretrained`` checkpoint
    (on the CPU), or without one the random init drawn on `device` from
    seed 0, as the JAX CLI draws it from PRNGKey(0)."""
    from vidil_tpu_torch.models import convert
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.train.common import model_cfgs

    vit_cfg, med_cfg = model_cfgs(config)
    tokenizer = BlipTokenizer(config["bert_vocab"])

    pretrained = config.get("pretrained", "")
    if pretrained:
        sd = convert.load_torch_state_dict(pretrained)
        params = convert.convert_blip_decoder(sd, vit_cfg, med_cfg)
    else:
        from vidil_tpu_torch.models.blip import init_blip_decoder
        from vidil_tpu_torch.utils.seeding import init_generator

        params = init_blip_decoder(init_generator(0, device), vit_cfg, med_cfg, device)
    return params, tokenizer, vit_cfg, med_cfg


def tokenize_captions(tokenizer, captions, max_length=40):
    """BLIP caption tokenization: [DEC] bos substituted, fixed-length pad
    (reference: models/blip.py:203-205)."""
    enc = tokenizer(captions, padding="max_length", truncation=True, max_length=max_length)
    ids = enc.input_ids.copy()
    ids[:, 0] = tokenizer.bos_token_id
    return ids, enc.attention_mask


@torch.no_grad()
def evaluate(params, loader, tokenizer, vit_cfg, med_cfg, config, dtype=torch.bfloat16):
    """Beam-search captions of every video of `loader` ({video_id, caption})."""
    from vidil_tpu_torch.models import blip as B
    from vidil_tpu_torch.ops.generation import GenerationConfig

    device = next(iter(params["visual_encoder"]["norm"].values())).device
    prompt = config.get("prompt", "a video of ")
    prompt_ids = tokenizer.encode(prompt)
    prompt_ids[0] = tokenizer.bos_token_id
    prompt_t = torch.tensor(prompt_ids[:-1], dtype=torch.int32, device=device)
    gen = GenerationConfig(
        max_length=config.get("max_length", 30), min_length=config.get("min_length", 5),
        num_beams=config.get("num_beams", 3), eos_token_id=tokenizer.sep_token_id,
        pad_token_id=tokenizer.pad_token_id,
    )
    result = []
    for video, video_ids in loader:
        video = torch.as_tensor(video, device=device)
        embeds = B.encode_video_frames(params, video, vit_cfg, dtype=dtype)
        prompt_b = prompt_t[None].expand(video.shape[0], -1)
        seqs = B.blip_generate_ids(params, embeds, prompt_b, med_cfg, gen, dtype=dtype,
                                   beam_group_kv=config.get("beam_group_kv", True))
        captions = B.decode_captions(tokenizer, seqs.cpu().numpy(), prompt)
        for vid, cap in zip(video_ids, captions):
            result.append({"video_id": vid, "caption": cap})
    return result


def main(args, config):
    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.datasets import (
        CaptionEvalDataset,
        CaptionTrainDataset,
        PrefetchLoader,
    )
    from vidil_tpu_torch.data.text_utils import save_result
    from vidil_tpu_torch.evals.caption import video_caption_eval
    from vidil_tpu_torch.pipeline.capfilt import resolve_device
    from vidil_tpu_torch.train.caption import (
        create_caption_train_state,
        make_caption_train_step,
        select_frame_itm,
    )
    from vidil_tpu_torch.parallel.mesh import grid_from_config
    from vidil_tpu_torch.parallel.sharding import apply_optimizer_sharding, gather_params
    from vidil_tpu_torch.train.common import loader_shards, resolve_train_batch, set_lr
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint, save_train_state
    from vidil_tpu_torch.utils.logging import MetricLogger
    from vidil_tpu_torch.utils.schedules import cosine_lr_schedule

    device = resolve_device(getattr(args, "device", "cuda"))
    owns_group = utils.init_distributed_mode(args, device=device)
    grid = grid_from_config(config)
    utils.seed_everything(args.seed)
    dtype = torch.bfloat16

    params, tokenizer, vit_cfg, med_cfg = build_model_and_tokenizer(config, device)
    prompt = config.get("prompt", "a video of ")
    prompt_length = len(tokenizer.encode(prompt)) - 1

    train_dataset = CaptionTrainDataset(dict(config), prompt=prompt)

    def eval_dataset(ann_key):
        return CaptionEvalDataset(config["video_root"], config[ann_key],
                                  num_frm=config["num_frm_test"],
                                  frm_sampling_strategy=config["frm_sampling_strategy"],
                                  max_img_size=config["image_size"])

    val_dataset, test_dataset = eval_dataset("val_ann_jsonl"), eval_dataset("test_ann_jsonl")
    print("train dataset size:", len(train_dataset))

    train_B = resolve_train_batch(config, "train_batch_size")
    train_loader = PrefetchLoader(train_dataset, train_B, shuffle=True,
                                  drop_last=True, seed=args.seed, **loader_shards(grid=grid))
    val_loader = PrefetchLoader(val_dataset, config["test_batch_size"],
                                **loader_shards(len(val_dataset)))
    test_loader = PrefetchLoader(test_dataset, config["test_batch_size"],
                                 **loader_shards(len(test_dataset)))

    state = create_caption_train_state(params, config["init_lr"],
                                       config.get("weight_decay", 0.05), device=device,
                                       grid=grid)
    state = apply_optimizer_sharding(state, config)
    del params
    train_step = make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=dtype,
                                         grid=grid)

    # 'single_frame' mode: pick the best-matching frame per caption with the
    # ITM filterer (reference: train_caption_video.py:30-36,137-143)
    single_frame = config.get("video_representation", "concat_frame") == "single_frame"
    if single_frame:
        from vidil_tpu_torch.models import convert

        filterer = convert.to_device(convert.convert_blip_itm(
            convert.load_torch_state_dict(config["filterer_model_ckpt"]), vit_cfg, med_cfg),
            device)

        def select_frames(video, ids, mask):
            out = []
            for b in range(video.shape[0]):
                idx = select_frame_itm(filterer, torch.as_tensor(video[b], device=device),
                                       torch.as_tensor(ids[b], device=device).long(),
                                       torch.as_tensor(mask[b], device=device).long(),
                                       vit_cfg, med_cfg, dtype=dtype)
                out.append(video[b, idx:idx + 1])
            return np.stack(out)  # (B, 1, S, S, C)

    # full-state resume (params, AdamW moments, step); the reference resumes
    # model + optimizer from its torch.save checkpoint
    start_epoch = 0
    resume_path = config.get("resume", "")
    if resume_path and not args.evaluate:
        utils.barrier()
        state, ck_meta = load_train_state(resume_path, state)
        start_epoch = (ck_meta or {}).get("epoch", -1) + 1
        print(f"resumed full train state from {resume_path} at epoch {start_epoch}")

    best, best_epoch = 0.0, 0
    for epoch in range(start_epoch, config["max_epoch"]):
        if not args.evaluate:
            train_loader.set_epoch(epoch)
            lr = cosine_lr_schedule(epoch, config["max_epoch"], config["init_lr"],
                                    config.get("min_lr", 0))
            set_lr(state.optimizer, lr)
            logger = MetricLogger(delimiter="  ")
            for video, captions in logger.log_every(train_loader, 50, f"Train epoch {epoch}"):
                ids, mask = tokenize_captions(tokenizer, list(captions))
                if single_frame:
                    video = select_frames(video, ids, mask)
                batch = {"video": np.asarray(video), "input_ids": ids, "attention_mask": mask}
                state, metrics = train_step(state, batch)
                logger.update(loss=float(metrics["loss"]), lr=lr)
            logger.synchronize_between_processes()
            train_stats = {k: f"{m.global_avg:.3f}" for k, m in logger.meters.items()}
            save_train_state(os.path.join(args.output_dir, "checkpoint_last"),
                             state, meta={"epoch": epoch})

        if epoch == config["max_epoch"] - 1 or args.evaluate:
            skip_val = config.get("skip_val", False)
            log_stats = {}
            eval_params = gather_params(state.params, grid)
            if not skip_val:
                val_result = evaluate(eval_params, val_loader, tokenizer, vit_cfg, med_cfg,
                                      config, dtype=dtype)
                val_file = save_result(val_result, args.result_dir, f"val_epoch{epoch}",
                                       remove_duplicate="video_id")
            test_result = evaluate(eval_params, test_loader, tokenizer, vit_cfg, med_cfg,
                                   config, dtype=dtype)
            test_file = save_result(test_result, args.result_dir, f"test_epoch{epoch}",
                                    remove_duplicate="video_id")
            if utils.is_main_process():
                if not skip_val:
                    video_val = video_caption_eval(config["val_ann_jsonl"], val_file)
                    log_stats.update({f"val_{k}": v for k, v in video_val.items()})
                video_test = video_caption_eval(config["test_ann_jsonl"], test_file)
                log_stats.update({f"test_{k}": v for k, v in video_test.items()})
                if args.evaluate:
                    with open(os.path.join(args.output_dir, "evaluate.txt"), "a") as f:
                        f.write(json.dumps(log_stats) + "\n")
                else:
                    # checkpoint best by val CIDEr + Bleu_4 (reference :216-219)
                    if skip_val or (video_val["CIDEr"] + video_val["Bleu_4"] > best):
                        if not skip_val:
                            best = video_val["CIDEr"] + video_val["Bleu_4"]
                            best_epoch = epoch
                        save_checkpoint(
                            os.path.join(args.output_dir, "checkpoint_best"), eval_params,
                            meta={"epoch": epoch, "config": {
                                k: v for k, v in config.items()
                                if isinstance(v, (str, int, float, bool, type(None)))}})
                    log_stats.update({f"train_{k}": v for k, v in train_stats.items()},
                                     epoch=epoch, best_epoch=best_epoch)
                    with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
                        f.write(json.dumps(log_stats) + "\n")
        if args.evaluate:
            break
        utils.barrier()
    if owns_group:
        utils.destroy_distributed()
    return state


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/train_blip_video_captioning_msrvtt.yaml")
    parser.add_argument("--output_dir", default="output/caption_video")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--dist_url", default="env://")
    parser.add_argument("--distributed", default=True, type=bool)
    return parser.parse_args(argv)


if __name__ == "__main__":
    from vidil_tpu_torch.config import dump_yaml_config, load_yaml_config

    args = parse_args()
    config = load_yaml_config(args.config)
    args.result_dir = os.path.join(args.output_dir, "result")
    Path(args.result_dir).mkdir(parents=True, exist_ok=True)
    dump_yaml_config(config, args.output_dir, sort_keys=True)
    main(args, config)
