"""Visual tokenization (CLIP/BLIP zero-shot frame tagging) on the GPU — the
port's CLI.

    python -m vidil_tpu_torch.run_visual_tokenization --config CONFIG.yaml \
        --output_dir OUT [--encoder_version clip|blip] [--device cuda]

The same argparse and yaml surface and the same output tree as the root
``run_visual_tokenization.py``: ``OUT/tmp/{rank}.json``, merged by rank 0
into ``OUT/visual_tokens.json``, then ``tmp/`` removed. Host decode runs in
a thread pool ahead of the device (bounded prefetch of two chunks), and the
frames go to the device from the decode threads through pinned memory.

Config keys beyond the reference's (offline environments): clip_ckpt /
clip_vocab / clip_merges (local CLIP weights and BPE files), clip_config,
bert_vocab, ontology_root, ontology_paths, videos_per_batch, vit_config
(e.g. ``{use_fused_mlp: true}`` for kernel K3 in the BLIP ViT),
compute_dtype ('bfloat16' | 'float32'), decode_workers.

Several GPUs: launch under ``torchrun --nproc_per_node=N``. Each rank
takes its `shard_range` of the videos on ``cuda:LOCAL_RANK``; rank 0
merges the tmp files after a barrier, so ``visual_tokens.json`` is the
same as one process writes. ``data_parallel: true`` runs on the launch's
ranks (one rank: the plain engine); ``data_parallel: N`` must match the
launch's world.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_clip_engine(config, dtype=None, device="cuda"):
    from vidil_tpu_torch.config import CLIPConfig, compute_dtype_from_config
    from vidil_tpu_torch.models.convert import convert_clip, load_torch_state_dict
    from vidil_tpu_torch.parallel.mesh import grid_from_config
    from vidil_tpu_torch.pipeline.visual_tokenization import ClipTokenizationEngine
    from vidil_tpu_torch.tokenizer import ClipBPETokenizer

    grid_from_config(config)  # the launch's world; the chunks split over all of it
    if "clip_config" in config:
        clip_cfg = CLIPConfig(**config["clip_config"])
    else:
        name = config.get("clip_model_visual_tokenization", "openai/clip-vit-large-patch14")
        clip_cfg = CLIPConfig.vit_l_14() if "large" in name else CLIPConfig.vit_b_32()
    params = convert_clip(load_torch_state_dict(config["clip_ckpt"]), clip_cfg)
    tok = ClipBPETokenizer(config["clip_vocab"], config["clip_merges"],
                           max_len=clip_cfg.max_text_len)
    return ClipTokenizationEngine(params, clip_cfg, tok,
                                  dtype=compute_dtype_from_config(config, dtype), device=device)


def build_blip_engine(config, dtype=None, device="cuda"):
    from vidil_tpu_torch.config import MedConfig, ViTConfig, compute_dtype_from_config
    from vidil_tpu_torch.models.convert import convert_blip_retrieval, load_torch_state_dict
    from vidil_tpu_torch.parallel.mesh import grid_from_config
    from vidil_tpu_torch.pipeline.visual_tokenization import BlipTokenizationEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    grid_from_config(config)  # the launch's world; the chunks split over all of it
    if "vit_config" in config:
        vit_cfg = ViTConfig(image_size=config["image_size"], **config["vit_config"])
    else:
        vit_cfg = ViTConfig.from_name(config["vit"], config["image_size"])
    med_cfg_path = config.get("med_config", os.path.join(REPO, "configs", "med_config.json"))
    med_cfg = MedConfig.from_json(med_cfg_path, encoder_width=vit_cfg.hidden_size)
    tok = BlipTokenizer(config["bert_vocab"])
    sd = load_torch_state_dict(config["blip_model_visual_tokenization"])
    params = convert_blip_retrieval(sd, vit_cfg, med_cfg, with_momentum=False)
    return BlipTokenizationEngine(params, vit_cfg, med_cfg, tok,
                                  k_test=config.get("k_test", 128),
                                  dtype=compute_dtype_from_config(config, dtype), device=device)


def load_annotations(config) -> list[dict]:
    """reference: data/video_pretrain_dataset.py:397-443 — list or dict ann
    jsons -> [{'video': path, 'video_id': id, 'caption': [texts]}]."""
    ann_jsons = config["train_ann_jsons"]
    video_roots = config["video_roots"]
    video_formats = config["video_formats"]
    if isinstance(ann_jsons, str):
        ann_jsons, video_roots, video_formats = [ann_jsons], [video_roots], [video_formats]
    annotation: dict = {}
    skipped = 0
    for ann_path, video_dir, fmt in zip(ann_jsons, video_roots, video_formats):
        with open(ann_path) as f:
            ann = json.load(f)
        if isinstance(ann, list):
            for obj in ann:
                vid = obj["video_id"]
                path = os.path.join(video_dir, f"{vid}.{fmt}")
                if not os.path.exists(path):
                    print(f"ERROR: video file not found, skipped:{path}")
                    skipped += 1
                    continue
                if vid not in annotation:
                    annotation[vid] = {"video": path, "video_id": vid, "caption": []}
                annotation[vid]["caption"] += obj["texts"]
        else:
            for vid, texts in ann.items():
                path = os.path.join(video_dir, f"{vid}.{fmt}")
                if not os.path.exists(path):
                    print(f"ERROR: video file not found, skipped:{path}")
                    skipped += 1
                    continue
                annotation[vid] = {"video": path, "video_id": vid, "caption": texts}
    print("num of video skipped:", skipped)
    print("num of video considering:", len(annotation))
    return list(annotation.values())


def main(args, config):
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.sampling import load_video_frames
    from vidil_tpu_torch.pipeline.capfilt import preprocess_frames_pil
    from vidil_tpu_torch.pipeline.visual_tokenization import (
        clip_preprocess_pil,
        get_prefix_prompt_functions,
        load_ontology,
        ontology_paths,
        predict_videos,
    )

    device = getattr(args, "device", "cuda")
    tmp_dir = os.path.join(args.output_dir, "tmp")
    os.makedirs(tmp_dir, exist_ok=True)

    owns_group = utils.init_distributed_mode(args, device=device)
    utils.seed_everything(args.seed)
    rank = utils.get_rank()

    if args.encoder_version == "clip":
        engine = build_clip_engine(config, device=device)
        preprocess = lambda frames: clip_preprocess_pil(frames, engine.cfg.image_size)
    elif args.encoder_version == "blip":
        engine = build_blip_engine(config, device=device)
        preprocess = lambda frames: preprocess_frames_pil(frames, config["image_size"])
    else:
        raise ValueError(f"unknown encoder_version {args.encoder_version}")

    prompt_functions = get_prefix_prompt_functions(config["prompt_version_visual_tokenization"])
    onto_root = config.get("ontology_root", "visual_token_ontology")
    if not os.path.isabs(onto_root) and not os.path.isdir(onto_root):
        # the ontology term lists vendored with the repo, from any working
        # directory
        vendored = os.path.join(REPO, onto_root)
        if os.path.isdir(vendored):
            onto_root = vendored
    if "ontology_paths" in config:
        paths = config["ontology_paths"]
    else:
        paths = ontology_paths(config["ontology"], onto_root)
    visual_token_texts = load_ontology(paths)
    for k in ("objects", "attributes", "verbs"):
        print(f"num of {k}:", len(visual_token_texts[k]))

    annotation = load_annotations(config)
    start, end = utils.shard_range(len(annotation))
    print(f"rank{rank}:start-{start}:end-{end}")
    shard = annotation[start:end]

    num_frm = config["num_frm_visual_tokenization"]
    chunk_size = int(config.get("videos_per_batch", 16))
    early_stop = config.get("early_stop_step", -1)
    on_cuda = engine.device.type == "cuda"

    text_cache: dict = {}
    videoid_2_visual_tokens: dict = {}
    t0 = time.time()
    n_frames = 0

    video_frames, captions = {}, {}

    def flush():
        nonlocal video_frames, captions, n_frames
        if not video_frames:
            return
        out = predict_videos(
            engine, video_frames, captions, visual_token_texts, prompt_functions,
            topk_visualize=config["topk_visualize"], text_cache=text_cache,
            pad_to_videos=chunk_size,
        )
        videoid_2_visual_tokens.update(out)
        n_frames += len(video_frames) * num_frm
        video_frames, captions = {}, {}

    def decode_one(ann):
        """Host decode + PIL resize of one video (thread-parallel); the
        frames leave for the device from this thread."""
        frames = load_video_frames(
            ann["video"], config["frm_sampling_strategy"], num_frm,
            height=config.get("height"), width=config.get("width"),
            start_time=config.get("start_time"), end_time=config.get("end_time"),
            fps=config.get("fps", -1),
        )
        if frames is None:
            return None
        t = torch.from_numpy(preprocess(frames))
        if on_cuda:  # pinned staging: the upload overlaps the device's work
            return t.pin_memory().to(engine.device, non_blocking=True)
        return t

    work = shard if early_stop < 0 else shard[:early_stop]
    if early_stop >= 0:
        print(f"early stop at {early_stop}")
    with ThreadPoolExecutor(max_workers=int(config.get("decode_workers", 4))) as pool:
        pending: deque = deque()
        it = iter(work)

        def top_up():
            while len(pending) < 2 * chunk_size:
                ann = next(it, None)
                if ann is None:
                    return
                pending.append((ann, pool.submit(decode_one, ann)))

        top_up()
        while pending:
            ann, fut = pending.popleft()
            frames = fut.result()
            top_up()
            video_name = os.path.basename(ann["video"])[:-4]
            if frames is None:
                print("skip video that cannot be loaded:", video_name)
                continue
            video_frames[video_name] = frames
            captions[video_name] = ann["caption"]
            if len(video_frames) == chunk_size:
                flush()
    flush()

    dt = time.time() - t0
    if n_frames:
        print(f"rank{rank}: {n_frames} frames in {dt:.1f}s = {n_frames/dt:.2f} frames/s")

    utils.save_json(os.path.join(tmp_dir, f"{rank}.json"), videoid_2_visual_tokens)
    utils.merge_rank_jsons(tmp_dir, os.path.join(args.output_dir, "visual_tokens.json"),
                           cleanup=True)
    if owns_group:
        utils.destroy_distributed()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/pipeline_config/pipeline_config_msrvtt_train.yaml")
    parser.add_argument("--output_dir", default="visual_token_generation/output/tmp")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--dist_url", default="env://")
    parser.add_argument("--distributed", default=True, type=bool)
    parser.add_argument("--encoder_version", default="clip")
    return parser.parse_args(argv)


if __name__ == "__main__":
    from vidil_tpu_torch.config import dump_yaml_config, load_yaml_config

    args = parse_args()
    config = load_yaml_config(args.config)
    config["num_frm_train"] = config["num_frm_visual_tokenization"]
    dump_yaml_config(config, args.output_dir, sort_keys=True)
    main(args, config)
