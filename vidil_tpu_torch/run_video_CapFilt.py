"""Frame captioning + ITM filtering (CapFilt) on the GPU — the port's CLI.

    python -m vidil_tpu_torch.run_video_CapFilt --config CONFIG.yaml --output_dir OUT [--device cuda]

The same argparse and yaml surface and the same output tree as the root
``run_video_CapFilt.py``: ``OUT/tmp/{rank}_filtered.json`` and
``{rank}_unfiltered.json``, merged by rank 0 into ``video_text_CapFilt.json``
and ``video_text_Cap.json``, then ``tmp/`` removed. Host decode runs in a
thread pool ahead of the device (bounded prefetch of two chunks), frames
go to the device from the decode threads, and one chunk stays in flight
when the fused filter applies.

Config keys honoured beyond the reference's: bert_vocab, videos_per_batch,
beam_group_kv, fused_filter, transfer_format ('rgb' | 'yuv420'),
compute_dtype ('bfloat16' | 'float32'), synthetic_weights, decode_workers,
and resize_on_device: frames go to the device at their native decode size
(native_height / native_width, else the first video's, even dims) and the
encode resizes them there; a video decoding at another size gets one host
PIL resample to that size, with one printed warning. generation_mode
'sample' draws each chunk's captions from a generator seeded afresh with
--seed, as the JAX CLI passes PRNGKey(seed) to every chunk.

Several GPUs: launch under ``torchrun --nproc_per_node=N``. Each rank
takes its `shard_range` of the videos on ``cuda:LOCAL_RANK`` and writes
its tmp files; rank 0 merges them after a barrier, so the two files are
the same as one process writes. ``data_parallel: true`` runs on the
launch's ranks (one rank: the plain engine); ``data_parallel: N`` must
match the launch's world.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

def build_engine(config, device="cuda", dtype=None):
    from vidil_tpu_torch.config import MedConfig, ViTConfig, compute_dtype_from_config
    from vidil_tpu_torch.models import convert
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine, resolve_device
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    from vidil_tpu_torch.parallel.mesh import grid_from_config

    device = resolve_device(device)
    grid_from_config(config)
    if "vit_config" in config:  # custom architecture (tests / non-standard sizes)
        vit_cfg = ViTConfig(image_size=config["image_size"], **config["vit_config"])
    else:
        vit_cfg = ViTConfig.from_name(config["vit"], config["image_size"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    med_cfg_path = config.get("med_config", os.path.join(repo, "configs", "med_config.json"))
    med_cfg = MedConfig.from_json(med_cfg_path, encoder_width=vit_cfg.hidden_size)
    tokenizer = BlipTokenizer(config["bert_vocab"])

    if config.get("synthetic_weights", False):
        # full-width params made on the device (captions are meaningless;
        # the compute path and shapes are the production ones)
        from vidil_tpu_torch.models.blip import blip_decoder_shapes, blip_itm_shapes
        from vidil_tpu_torch.utils.synth import synth_tree

        captioner = convert.from_jax_params(
            synth_tree(blip_decoder_shapes(vit_cfg, med_cfg), device, salt=1.0))
        filterer = convert.from_jax_params(
            synth_tree(blip_itm_shapes(vit_cfg, med_cfg), device, salt=2.0))
    else:
        cap_sd = convert.load_torch_state_dict(config["caption_model_ckpt"])
        captioner = convert.convert_blip_decoder(cap_sd, vit_cfg, med_cfg)
        fil_sd = convert.load_torch_state_dict(config["filterer_model_ckpt"])
        filterer = convert.convert_blip_itm(fil_sd, vit_cfg, med_cfg)

    return CapFiltEngine(
        captioner, filterer, tokenizer, vit_cfg, med_cfg,
        num_beams=3, max_length=20, min_length=5,  # reference run_video_CapFilt.py:101
        dtype=compute_dtype_from_config(config, dtype),
        beam_group_kv=config.get("beam_group_kv", True),
        fused_filter=config.get("fused_filter", True),
        device=device,
    )


def main(args, config):
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from vidil_tpu_torch import utils
    from vidil_tpu_torch.data.sampling import load_video_frames
    from vidil_tpu_torch.ops.image import YUV420Frames, rgb_to_yuv420
    from vidil_tpu_torch.pipeline.capfilt import preprocess_frames_pil
    from vidil_tpu_torch.pipeline.fused_filter import fused_applicable

    device = getattr(args, "device", "cuda")
    video_format = config["video_formats"]
    video_dir = config["video_roots"]
    with open(config["train_ann_jsons"]) as f:
        video_2_text_original = json.load(f)
    data = []
    for key, text in video_2_text_original.items():
        video_path = os.path.join(video_dir, f"{key}.{video_format}")
        if os.path.exists(video_path):
            data.append({"video_path": video_path, "text": text, "video_id": key})
        else:
            print(f"skip: {key}")
    print("number of existing videos:", len(data))

    tmp_dir = os.path.join(args.output_dir, "tmp")
    os.makedirs(tmp_dir, exist_ok=True)

    owns_group = utils.init_distributed_mode(args, device=device)
    utils.seed_everything(args.seed)

    rank = utils.get_rank()
    start, end = utils.shard_range(len(data))
    print(f"rank{rank}:start-{start}:end-{end}")
    shard = data[start:end]

    engine = build_engine(config, device=device)
    chunk_size = int(config.get("videos_per_batch", 8))
    num_frm = config["num_frm_CapFilt"]
    image_size = config["image_size"]
    yuv = config.get("transfer_format", "rgb") == "yuv420"
    on_cuda = engine.device.type == "cuda"

    def to_device(a: np.ndarray):
        t = torch.from_numpy(a)
        if on_cuda:  # pinned staging: the upload overlaps the device's work
            return t.pin_memory().to(engine.device, non_blocking=True)
        return t

    resize_dev = bool(config.get("resize_on_device", False))
    # the native (H, W) every chunk ships at under resize_on_device: the
    # config's, else the first decoded video's (even dims, for I420)
    native_hw = None
    if config.get("native_height") and config.get("native_width"):
        native_hw = (int(config["native_height"]) & ~1, int(config["native_width"]) & ~1)
    native_lock = threading.Lock()
    offspec_warned = False

    def native_frames(item, frames):
        """Frames at the run's native size: cropped to even dims, or, for
        a video that decodes at another size, one host PIL resample."""
        nonlocal native_hw, offspec_warned
        with native_lock:
            if native_hw is None:
                native_hw = (frames.shape[1] & ~1, frames.shape[2] & ~1)
            h, w = native_hw
            warn = frames.shape[1:3] != (h, w) and not offspec_warned
            offspec_warned = offspec_warned or warn
        if frames.shape[1:3] == (h, w):
            return frames[:, :h, :w]
        if warn:
            print(f"resize_on_device: video {item['video_id']} decodes at "
                  f"{frames.shape[1]}x{frames.shape[2]}, host-resampling off-spec videos "
                  f"to the chunk-native {h}x{w}")
        out = np.empty((len(frames), h, w, 3), np.uint8)
        for i, frm in enumerate(frames):
            out[i] = np.asarray(Image.fromarray(frm).resize((w, h), Image.BICUBIC))
        return out

    def decode_item(item):
        """Host decode + PIL resize (or, under resize_on_device, the native
        frames) of one video (thread-parallel); the frames leave for the
        device from this thread."""
        frames = load_video_frames(
            item["video_path"], config["frm_sampling_strategy"], num_frm,
            height=config.get("height"), width=config.get("width"),
            start_time=config.get("start_time"), end_time=config.get("end_time"),
            fps=config.get("fps", -1),
        )
        if frames is None:
            return None
        pre = native_frames(item, frames) if resize_dev else preprocess_frames_pil(frames, image_size)
        if yuv:
            dev = YUV420Frames(*(to_device(p) for p in rgb_to_yuv420(pre)))
        else:
            dev = to_device(pre)
        return {"video_id": item["video_id"], "frames": dev, "text": item["text"]}

    video_text_CapFilt = {}
    video_text_Cap_unfiltered = {}
    t0 = time.time()
    n_frames = 0
    t_steady = None  # set when the first chunk completes
    n_frames_steady = 0

    keep_in_flight = engine.fused_filter and fused_applicable(config)
    in_flight = None  # (dispatch, meta, real)

    def drain_chunk(d, meta, real):
        nonlocal n_frames, t_steady, n_frames_steady
        results = engine.complete_chunk(d)
        if t_steady is None:
            t_steady, n_frames_steady = time.time(), n_frames + real * num_frm
        for item, res in zip(meta, results[:real]):
            video_text_Cap_unfiltered[res.video_id] = res.unfiltered_text
            if res.text != []:
                video_text_CapFilt[res.video_id] = res.text
            else:
                print("filter out video:", res.video_id)
        n_frames += real * num_frm

    def flush_in_flight():
        nonlocal in_flight
        if in_flight is not None:
            d, meta, real = in_flight
            in_flight = None
            drain_chunk(d, meta, real)

    def run_chunk(chunk, meta):
        nonlocal in_flight
        real = len(chunk)
        while len(chunk) < chunk_size:  # fixed chunk shape
            chunk.append({**chunk[0]})
        # sampling: every chunk draws from a generator seeded afresh with
        # --seed (the JAX CLI passes PRNGKey(seed) to every chunk)
        rng = torch.Generator(device=engine.device).manual_seed(args.seed)
        d = engine.dispatch_chunk(chunk, config, rng=rng, n_real=real)
        if keep_in_flight:
            flush_in_flight()
            in_flight = (d, meta, real)
        else:
            drain_chunk(d, meta, real)

    with ThreadPoolExecutor(max_workers=int(config.get("decode_workers", 4))) as pool:
        pending: deque = deque()
        it = iter(shard)

        def top_up():
            while len(pending) < 2 * chunk_size:
                item = next(it, None)
                if item is None:
                    return
                pending.append((item, pool.submit(decode_item, item)))

        top_up()
        chunk, meta = [], []
        while pending:
            item, fut = pending.popleft()
            dec = fut.result()
            top_up()
            if dec is None:
                print(f'skip video that cannot be loaded: {item["video_path"]}')
                continue
            chunk.append(dec)
            meta.append(item)
            if len(chunk) == chunk_size:
                run_chunk(chunk, meta)
                chunk, meta = [], []
        if chunk:
            run_chunk(chunk, meta)
        flush_in_flight()

    dt = time.time() - t0
    if n_frames:
        print(f"rank{rank}: {n_frames} frames in {dt:.1f}s = {n_frames/dt:.2f} frames/s")
    if t_steady is not None and n_frames > n_frames_steady:
        ds, fs = time.time() - t_steady, n_frames - n_frames_steady
        print(f"rank{rank}: steady-state (first chunk excluded): "
              f"{fs} frames in {ds:.1f}s = {fs/ds:.2f} frames/s")

    utils.save_json(os.path.join(tmp_dir, f"{rank}_filtered.json"), video_text_CapFilt)
    utils.save_json(os.path.join(tmp_dir, f"{rank}_unfiltered.json"), video_text_Cap_unfiltered)

    merged_filtered = utils.merge_rank_jsons(
        tmp_dir, os.path.join(args.output_dir, "video_text_CapFilt.json"), "_filtered.json")
    merged_unfiltered = utils.merge_rank_jsons(
        tmp_dir, os.path.join(args.output_dir, "video_text_Cap.json"), "_unfiltered.json",
        cleanup=True)
    if utils.is_main_process():
        print("filtered video number:", len(merged_filtered))
        print("unfiltered video number:", len(merged_unfiltered))
    if owns_group:
        utils.destroy_distributed()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="none")
    parser.add_argument("--output_dir", default="output/video_CapFilt")
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
    dump_yaml_config(config, args.output_dir, sort_keys=True)
    main(args, config)
