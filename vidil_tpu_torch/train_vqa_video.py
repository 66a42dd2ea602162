"""BLIP video VQA fine-tuning on the GPU — the port's CLI.

    python -m vidil_tpu_torch.train_vqa_video --config CONFIG.yaml --output_dir OUT [--device cuda]

The same argparse and yaml surface as the root ``train_vqa_video.py`` and
the same loop: the weighted answer LM loss over ragged answers, per-epoch
cosine LR, then each epoch a 'generate' (beam search, 3 beams, 10 tokens)
or 'rank' (top-``k_test`` first-token candidates from ``answer_list_json``,
reranked by the full answer) pass over the test split into
``result/vqa_result_epoch<N>.json``, ``checkpoint_best.npz`` (in the JAX
package's npz layout, so its `load_checkpoint` reads it) and
``checkpoint_last.npz`` (the full train state, for ``resume:``). The towers
compute in bf16 over fp32 master parameters; on the card the ViT runs the
fused block pair (`train/common.py:training_cfgs`; opt out with
``VIDIL_TPU_TRAIN_FUSED_BLOCK=0``).

Config keys beyond the reference's: bert_vocab, optional vit_config /
med_config for custom sizes. The batch is the reference's
``batch_size_train``; a ``batch_size_train_tpu`` key is reported and
ignored. Not ported yet (they raise NotImplementedError): the SPMD mesh
keys (data_parallel, model_parallel, optimizer_sharding), multi-process
launches.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

QUESTION_TOKENS, ANSWER_TOKENS, ANSWER_BEAMS = 35, 12, 3


def build(config):
    from vidil_tpu_torch.models import convert
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.train.common import model_cfgs

    vit_cfg, med_cfg = model_cfgs(config)
    tokenizer = BlipTokenizer(config["bert_vocab"])
    pretrained = config.get("pretrained", "")
    if pretrained:
        params = convert.convert_blip_vqa(convert.load_torch_state_dict(pretrained),
                                          vit_cfg, med_cfg)
    else:
        # deterministic synthetic weights (the JAX CLI initialises randomly
        # from PRNGKey(0); its numbers cannot be reproduced here)
        from vidil_tpu_torch.models.blip_vqa import blip_vqa_shapes
        from vidil_tpu_torch.utils.synth import synth_tree

        params = convert.from_jax_params(
            synth_tree(blip_vqa_shapes(vit_cfg, med_cfg), "cpu", salt=1.0))
    return params, tokenizer, vit_cfg, med_cfg


def tokenize_questions(tokenizer, questions):
    """[ENC]-prefixed questions padded to 35 tokens (reference :49-51)."""
    enc = tokenizer(questions, padding="max_length", truncation=True, max_length=QUESTION_TOKENS)
    ids = enc.input_ids.copy()
    ids[:, 0] = tokenizer.enc_token_id
    return ids, enc.attention_mask


def tokenize_answers(tokenizer, answers, **kw):
    """[DEC]-prefixed answers (reference models/blip_vqa.py:226-228)."""
    enc = tokenizer(answers, **kw)
    ids = enc.input_ids.copy()
    ids[:, 0] = tokenizer.bos_token_id
    return ids, enc.attention_mask


def vqa_batch(tokenizer, videos, questions, answers, weights, n):
    """One collated batch (`vqa_collate`) -> the train step's arrays."""
    q_ids, q_mask = tokenize_questions(tokenizer, list(questions))
    a_ids, a_mask = tokenize_answers(tokenizer, list(answers), padding="max_length",
                                     truncation=True, max_length=ANSWER_TOKENS)
    return {"video": np.asarray(videos), "question_ids": q_ids, "question_mask": q_mask,
            "answer_ids": a_ids, "answer_mask": a_mask,
            "answer_question_index": np.repeat(np.arange(len(n)), n).astype(np.int64),
            "weights": np.asarray(weights, np.float32)}


@torch.no_grad()
def evaluate(params, loader, tokenizer, vit_cfg, med_cfg, config, dtype=torch.bfloat16):
    """Answers for every question of `loader` ({question_id, answer})."""
    from vidil_tpu_torch.models.blip import encode_video_frames
    from vidil_tpu_torch.models.blip_vqa import rank_answer, vqa_generate_ids

    device = next(iter(params["visual_encoder"]["norm"].values())).device
    inference = config.get("inference", "generate")
    if inference == "rank":
        with open(config["answer_list_json"]) as f:
            answer_list = json.load(f)
        a_ids, a_mask = (torch.as_tensor(a, device=device).long()
                         for a in tokenize_answers(tokenizer, answer_list, padding="longest"))
    result = []
    for videos, questions, question_ids in loader:
        q_ids, q_mask = (torch.as_tensor(a, device=device).long()
                         for a in tokenize_questions(tokenizer, list(questions)))
        embeds = encode_video_frames(params, torch.as_tensor(videos, device=device), vit_cfg,
                                     dtype=dtype)
        if inference == "generate":
            seqs = vqa_generate_ids(params, embeds, q_ids, q_mask, med_cfg, tokenizer,
                                    max_length=10, num_beams=ANSWER_BEAMS, dtype=dtype,
                                    beam_group_kv=config.get("beam_group_kv", True))
            answers = tokenizer.batch_decode(seqs.cpu().numpy())
        else:
            idxs = rank_answer(params, embeds, q_ids, q_mask, a_ids, a_mask,
                               k=config.get("k_test", 128), med_cfg=med_cfg,
                               tokenizer=tokenizer, dtype=dtype)
            answers = [answer_list[int(i)] for i in idxs.cpu().numpy()]
        for qid, ans in zip(question_ids, answers):
            result.append({"question_id": int(qid), "answer": ans})
    return result


def main(args, config):
    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.datasets import PrefetchLoader, VQADataset, vqa_collate
    from vidil_tpu_torch.data.text_utils import save_result
    from vidil_tpu_torch.pipeline.capfilt import resolve_device
    from vidil_tpu_torch.train.common import refuse_mesh_keys, resolve_train_batch, set_lr
    from vidil_tpu_torch.train.vqa import create_vqa_train_state, make_vqa_train_step
    from vidil_tpu_torch.utils.checkpoint import load_train_state, save_checkpoint, save_train_state
    from vidil_tpu_torch.utils.logging import MetricLogger
    from vidil_tpu_torch.utils.schedules import cosine_lr_schedule

    device = resolve_device(getattr(args, "device", "cuda"))
    refuse_mesh_keys(config)
    utils.init_distributed_mode(args)
    utils.seed_everything(args.seed)
    dtype = torch.bfloat16
    params, tokenizer, vit_cfg, med_cfg = build(config)

    train_loader = PrefetchLoader(VQADataset(config, split="train"),
                                  resolve_train_batch(config, "batch_size_train", 16),
                                  shuffle=True, drop_last=True, collate_fn=vqa_collate,
                                  seed=args.seed)
    test_loader = PrefetchLoader(VQADataset(config, split="test"),
                                 config.get("batch_size_test", 16))

    state = create_vqa_train_state(params, config["init_lr"], config.get("weight_decay", 0.05),
                                   device=device)
    del params
    train_step = make_vqa_train_step(vit_cfg, med_cfg, dtype=dtype)

    start_epoch = 0
    resume_path = config.get("resume", "")
    if resume_path and not args.evaluate:
        state, ck_meta = load_train_state(resume_path, state)
        start_epoch = (ck_meta or {}).get("epoch", -1) + 1
        print(f"resumed full train state from {resume_path} at epoch {start_epoch}")

    for epoch in range(start_epoch, config["max_epoch"]):
        if not args.evaluate:
            train_loader.set_epoch(epoch)
            lr = cosine_lr_schedule(epoch, config["max_epoch"], config["init_lr"],
                                    config.get("min_lr", 0))
            set_lr(state.optimizer, lr)
            logger = MetricLogger(delimiter="  ")
            for item in logger.log_every(train_loader, 50, f"Train epoch {epoch}"):
                state, metrics = train_step(state, vqa_batch(tokenizer, *item))
                logger.update(loss=float(metrics["loss"]), lr=lr)

        result = evaluate(state.params, test_loader, tokenizer, vit_cfg, med_cfg, config,
                          dtype=dtype)
        save_result(result, args.result_dir, f"vqa_result_epoch{epoch}")
        if utils.is_main_process() and not args.evaluate:
            save_checkpoint(os.path.join(args.output_dir, "checkpoint_best"), state.params,
                            meta={"epoch": epoch})
            save_train_state(os.path.join(args.output_dir, "checkpoint_last"),
                             state, meta={"epoch": epoch})
        if args.evaluate:
            break
        utils.barrier()
    return state


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/train_blip_video_vqa_msrvtt.yaml")
    parser.add_argument("--output_dir", default="output/vqa_video")
    parser.add_argument("--evaluate", action="store_true")
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
    args.result_dir = os.path.join(args.output_dir, "result")
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    Path(args.result_dir).mkdir(parents=True, exist_ok=True)
    with open(os.path.join(args.output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    main(args, config)
