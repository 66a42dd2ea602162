"""Smoke test of the PyTorch/CUDA port on one GPU: builds the port's CUDA
kernels, holds each against its plain PyTorch version at the main paths'
shapes, and drives the two main paths at full BLIP-base width: CapFilt
(384 px) and the caption fine-tuning step (224 px).

    python3 chip_smoke.py

Needs a CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); imports only
vidil_tpu_torch (no JAX). Phases, each of which fails the run:
  1. card: name and power limit (nvidia-smi);
  2. build: nvcc of every kernel source, with the build seconds;
  3. kernel check: the flash-attention kernel against its twin at the ViT
     self-attention shape (32, 12, 577, 64) and the grouped-ITM fold
     (q (32, 12, 96, 64) over k/v (32, 12, 577, 64)), bf16 and fp32, on
     contiguous tensors and on the main path's strided views, with
     CUDA-event times of the kernel, the twin and
     F.scaled_dot_product_attention (timed as a yardstick only);
  4. main path: CapFiltEngine.dispatch_chunk / complete_chunk over chunks of
     8 videos x 4 frames (RGB and YUV420), synthetic full-width weights,
     bf16, beam_group_kv and the fused filter; the kernel's launch count
     must show it ran in both encodes and in the ITM;
  5. stage breakdown of one RGB and one YUV420 chunk (host clock, synced);
  6. in-situ check: the captioner encode once through the kernel and once
     through the twin, with the embeddings' max abs diff (bf16, one block
     and twelve; fp32) and the caption token agreement (reported, not a
     pass bar: bf16 beam search turns ulps into different tokens);
  7. training kernels: the forward kernel with its logsumexp rows against
     its twin (o and lse) at the ViT shapes and the 224-px trainer's
     (48, 12, 197, 64), timed against the inference launch; the backward
     kernel against its twin, given the same (o, lse), at (48, 12, 197, 64)
     and (32, 12, 577, 64), bf16 and fp32, on the strided views the step
     passes, with the backward of F.scaled_dot_product_attention timed as a
     yardstick only;
  8. training main path: make_caption_train_step at full width (ViT-B/16
     224 px, MED from configs/med_config.json), synthetic weights, one
     fixed batch of 12 videos x 4 frames with 40-token captions, bf16, MED
     remat on, 8 steps: finite losses, the last below the first, non-zero
     ViT qkv gradients, and exactly 12 forward-with-lse and 12 backward
     launches per step; steady step ms (CUDA events), samples/s, peak memory;
  9. in-situ check of the backward: one ViT block's input gradient and qkv
     weight gradient through the kernels and through the twins (reported).
The last two lines are the kernels' JSON record and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data sheet (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# kernel vs twin at the kernel's own tiling: only the fp32 summation order
# differs, which can move a bf16 rounding by one ulp (|o| < 1 here)
ATOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}

N_VIDEOS, N_FRAMES, N_CHUNKS = 8, 4, 5  # chunk 0 warms up; 1.. are steady state
REPS = 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median CUDA-event time of one call over REPS calls after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(q, k, dtype, with_lse=False):
    """Least time for the call: q, k, v read once and o (and the fp32 lse
    rows) written once over HBM, or its 4*B*H*Lq*Lk*D operations at the
    dtype's peak rate."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * q.element_size() + with_lse * B * H * Lq * 4
    flops = 4 * B * H * Lq * Lk * D
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _main_path_views(label, gen, device, dtype):
    """q, k, v as the main path hands them to the kernel: head-split views
    of projection outputs (no copies). vit: one fused QKV projection of 32
    frames x 577 tokens; itm: 4 texts x 24 tokens per frame, folded into 96
    query rows over the frame's 577-token memory."""
    from vidil_tpu_torch.models.layers import split_heads

    H = 12
    if label == "vit_self_attention":
        qkv = torch.randn((32, 577, 3 * 768), generator=gen, device=device).to(dtype)
        return tuple(split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    q = split_heads(torch.randn((32 * 4, 24, 768), generator=gen, device=device).to(dtype), H)
    q = q.reshape(32, 4, H, 24, 64).transpose(1, 2).reshape(32, H, 96, 64)
    k = split_heads(torch.randn((32, 577, 768), generator=gen, device=device).to(dtype), H)
    v = split_heads(torch.randn((32, 577, 768), generator=gen, device=device).to(dtype), H)
    return q, k, v


def check_flash_kernel(fa, device):
    """Phase 3: kernel vs twin at both main-path shapes, bf16 and fp32, on
    contiguous tensors and on the strided views the main path passes."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = {"vit_self_attention": ((32, 12, 577, 64), (32, 12, 577, 64)),
              "itm_grouped_fold": ((32, 12, 96, 64), (32, 12, 577, 64))}
    for dtype in (torch.bfloat16, torch.float32):
        for label, (qs, ks) in shapes.items():
            for layout in ("contiguous", "views"):
                if layout == "views":
                    q, k, v = _main_path_views(label, gen, device, dtype)
                else:
                    q = torch.randn(qs, generator=gen, device=device).to(dtype)
                    k = torch.randn(ks, generator=gen, device=device).to(dtype)
                    v = torch.randn(ks, generator=gen, device=device).to(dtype)
                got = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                want = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= ATOL[dtype]
                bound, bound_by = attention_bound_ms(q, k, dtype)
                twin = lambda: fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K)
                row = dict(shape=label, layout=layout, dtype=str(dtype).replace("torch.", ""),
                           q=list(qs), kv=list(ks), max_abs_err=err, atol=ATOL[dtype],
                           ms=time_ms(lambda: fa.flash_attention(q, k, v)),
                           plain_ms=time_ms(twin),
                           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                           bound_ms=bound, bound_by=bound_by)
                log("kernel check:", json.dumps(row))
                rows.append(row)
                if not ok:
                    raise SystemExit(f"flash_attention_fwd disagrees with its twin: {row}")
    return rows


def make_engine(device):
    import os

    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 384)
    repo = os.path.dirname(os.path.abspath(__file__))
    med_cfg = MedConfig.from_json(os.path.join(repo, "configs", "med_config.json"),
                                  encoder_width=vit_cfg.hidden_size)
    with tempfile.TemporaryDirectory() as tmp:
        # 30524 entries with BLIP's [DEC]/[ENC]; plain words at every id but
        # the specials, so most random-weight captions re-tokenize stably
        # and the fused filter decides
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        tok = BlipTokenizer(vocab)
    cap = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                             device, salt=1.0))
    fil = convert.from_jax_params(synth_tree(blip.blip_itm_shapes(vit_cfg, med_cfg),
                                             device, salt=2.0))
    engine = CapFiltEngine(cap, fil, tok, vit_cfg, med_cfg, num_beams=3, max_length=20,
                           min_length=5, dtype=torch.bfloat16, beam_group_kv=True,
                           fused_filter=True, device=device)
    return engine, vit_cfg, med_cfg


def make_chunks(yuv_chunks):
    from vidil_tpu_torch.ops.image import rgb_to_yuv420

    rng = np.random.default_rng(0)
    chunks = []
    for c in range(N_CHUNKS):
        chunk = []
        for v in range(N_VIDEOS):
            frames = rng.integers(0, 256, (N_FRAMES, 384, 384, 3), dtype=np.uint8)
            if c in yuv_chunks:
                frames = rgb_to_yuv420(frames)
            chunk.append({"video_id": f"c{c}v{v}", "frames": frames, "text": []})
        chunks.append(chunk)
    return chunks


CONFIG = dict(caption=True, filter=True, filter_generated_only=True,
              keep_original_caption=False, filter_mode="max_filter",
              generation_mode="beam", threshold=0.4, do_sentence_tokenization=True)


def run_main_path(engine, fa, chunks, per_chunk):
    """Phase 4: dispatch/complete with one chunk in flight, as the CLI does.
    Returns (results, launches, steady frames/s, peak bytes)."""
    from vidil_tpu_torch.ops.image import YUV420Frames

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    results, t_steady, frames_steady = [], None, 0
    in_flight = None
    classic_calls = 0
    for chunk in chunks + [None]:
        if chunk is not None:
            before = fa.launch_counts["flash_attention_fwd"]
            d = engine.dispatch_chunk(chunk, CONFIG)
            got = fa.launch_counts["flash_attention_fwd"] - before
            if got != per_chunk:
                raise SystemExit(f"dispatch launched the kernel {got} times, want {per_chunk}")
        if in_flight is not None:
            fallback_before = engine.fused_fallback_videos
            results.extend(engine.complete_chunk(in_flight))
            classic_calls += engine.fused_fallback_videos > fallback_before
            if t_steady is None:
                t_steady = time.time()
            else:
                frames_steady += N_VIDEOS * N_FRAMES
        in_flight = d if chunk is not None else None
    fps = frames_steady / (time.time() - t_steady)
    launches = fa.launch_counts["flash_attention_fwd"]
    yuv = sum(isinstance(c[0]["frames"], YUV420Frames) for c in chunks)
    log(f"main path: {len(chunks)} chunks ({yuv} YUV420), {classic_calls} with a classic "
        f"filter fallback call, {launches} kernel launches")
    return results, launches, classic_calls, fps, torch.cuda.max_memory_allocated()


def stage_breakdown(engine, chunk):
    """Host-clock seconds of each device stage of one chunk, with a sync
    after each; 'enqueue' is the host time to issue the stage's work, so
    enqueue ~= total marks a stage bound by the host's launches."""
    from vidil_tpu_torch.pipeline.capfilt import ChunkDispatch, _concat_frames
    from vidil_tpu_torch.ops.image import YUV420Frames

    out = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        r = fn()
        t1 = time.time()
        torch.cuda.synchronize()
        out[name] = {"enqueue_s": t1 - t0, "total_s": time.time() - t0}
        return r

    host = _concat_frames([c["frames"] for c in chunk])
    up = lambda a: torch.from_numpy(a).to(engine.device)
    frames = stage("upload", lambda: YUV420Frames(*map(up, host)) if isinstance(host, YUV420Frames)
                   else up(host))
    embeds = stage("captioner_encode", lambda: engine.encode_captioner(frames))
    seqs = stage("beam_decode", lambda: engine.generate_beam(embeds))
    fe = stage("filterer_encode", lambda: engine.encode_filter_frames(frames, N_FRAMES))
    probs = stage("itm_fused", lambda: engine._itm_fused(fe, seqs))
    d = ChunkDispatch(chunk, CONFIG, N_FRAMES, seqs, fe, probs)
    stage("complete_host", lambda: engine.complete_chunk(d))
    return out


def in_situ_check(engine, fa, frames, vit_cfg, med_cfg):
    """Phase 6: the same captioner encode through the kernel and through
    the twin (at the kernel's tiling), after one block and after all
    twelve, in bf16 and in fp32 (an fp32 copy of the same synthetic
    weights). One block shows the kernel's own difference; twelve show how
    far the network amplifies it."""
    from vidil_tpu_torch.models import blip, convert, vit
    from vidil_tpu_torch.ops.image import preprocess_any
    from vidil_tpu_torch.utils.synth import synth_tree

    def twin(q, k, v):
        return fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K)

    def both(fn):
        a = fn()
        orig = vit.attention_auto
        vit.attention_auto = twin
        try:
            b = fn()
        finally:
            vit.attention_auto = orig
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit("in-situ check: non-finite embeddings")
        return a, b, (a.float() - b.float()).abs().max().item()

    x = preprocess_any(engine._put(frames), vit_cfg.image_size)
    ve = engine.captioner_params["visual_encoder"]
    emb_k, emb_t, diff = both(lambda: engine.encode_captioner(frames))
    one_block = dict(ve, blocks=ve["blocks"][:1])
    _, _, diff1 = both(lambda: vit.vit_forward(one_block, x, vit_cfg, dtype=torch.bfloat16))
    ve32 = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                              x.device, salt=1.0))["visual_encoder"]
    _, _, diff32 = both(lambda: vit.vit_forward(ve32, x, vit_cfg, dtype=None))
    _, _, diff32_1 = both(lambda: vit.vit_forward(dict(ve32, blocks=ve32["blocks"][:1]), x,
                                                  vit_cfg, dtype=None))
    seqs_k, seqs_t = engine.generate_beam(emb_k), engine.generate_beam(emb_t)
    lp = engine.prompt_length
    agree = (seqs_k[:, lp:] == seqs_t[:, lp:]).float().mean().item()
    return {"bf16_embeddings_max_abs_diff": diff, "bf16_one_block_max_abs_diff": diff1,
            "fp32_embeddings_max_abs_diff": diff32, "fp32_one_block_max_abs_diff": diff32_1,
            "embeddings_max_abs": emb_k.float().abs().max().item(),
            "caption_token_agreement_bf16": agree, "frames": int(x.shape[0])}


# ---------------------------------------------------------------------------
# training: the forward with logsumexp rows, the backward, the train step
# ---------------------------------------------------------------------------

# kernel vs twin, lse rows: fp32 summation order; in bf16 one flipped
# rounding of a p term moves lse by <= 2**-8 (l >= 1)
LSE_ATOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
# backward kernel vs twin, max abs error over the largest twin gradient:
# fp32 summation order, which can move a bf16 rounding of ds or of the
# outputs by one ulp (2**-8 relative)
BWD_RTOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
TRAIN_VIDEOS, TRAIN_FRAMES, TRAIN_TOKENS, TRAIN_STEPS = 12, 4, 40, 8


def attention_bwd_bound_ms(q, k, dtype):
    """Least time for the backward: q, k, v, o, g and lse read once, dq, dk
    and dv written once, or its five products (q kᵀ, g vᵀ, pᵀ g, dsᵀ q,
    ds k; 10·B·H·Lq·Lk·D operations) at the dtype's peak rate."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    nbytes = (4 * B * H * Lq * D + 4 * B * H * Lk * D) * q.element_size() + B * H * Lq * 4
    flops = 10 * B * H * Lq * Lk * D
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _train_views(B, L, gen, device, dtype):
    """q, k, v as head-split views of one QKV projection and g as the head
    split of a merge_heads gradient, as the train step hands them over."""
    from vidil_tpu_torch.models.layers import split_heads

    qkv = torch.randn((B, L, 3 * 768), generator=gen, device=device).to(dtype)
    q, k, v = (split_heads(t, 12) for t in qkv.chunk(3, dim=-1))
    g = split_heads(torch.randn((B, L, 768), generator=gen, device=device).to(dtype), 12)
    return q, k, v, g


def check_fwd_lse(fa, device):
    """Phase 7a: the forward with lse rows vs its twin, and its time
    against the inference launch on the same inputs."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L in (("vit_self_attention", 32, 577), ("train_224", 48, 197)):
            for layout in ("contiguous", "views"):
                q, k, v, _ = _train_views(B, L, gen, device, dtype)
                if layout == "contiguous":
                    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                o, lse = fa._launch(q, k, v, with_lse=True)
                torch.cuda.synchronize()
                want_o, want_lse = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K,
                                                          return_lse=True)
                err = (o.float() - want_o.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                ok = (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
                      and err <= ATOL[dtype] and lse_err <= LSE_ATOL[dtype])
                bound, bound_by = attention_bound_ms(q, k, dtype, with_lse=True)
                row = dict(shape=label, layout=layout, dtype=str(dtype).replace("torch.", ""),
                           q=[B, 12, L, 64], max_abs_err=err, lse_max_abs_err=lse_err,
                           atol=ATOL[dtype], lse_atol=LSE_ATOL[dtype],
                           ms=time_ms(lambda: fa._launch(q, k, v, with_lse=True)),
                           inference_ms=time_ms(lambda: fa._launch(q, k, v)),
                           plain_ms=time_ms(lambda: fa.flash_attention_ref(
                               q, k, v, block_k=fa.KERNEL_BLOCK_K, return_lse=True)),
                           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                           bound_ms=bound, bound_by=bound_by)
                log("kernel check (fwd with lse):", json.dumps(row))
                rows.append(row)
                if not ok:
                    raise SystemExit(f"flash_attention_fwd_lse disagrees with its twin: {row}")
    return rows


def check_bwd(fa, device):
    """Phase 7b: the backward kernel vs its twin on the same (o, lse),
    bf16 and fp32, on the step's strided views."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L in (("train_224", 48, 197), ("train_384", 32, 577)):
            q, k, v, g = _train_views(B, L, gen, device, dtype)
            o, lse = fa._launch(q, k, v, with_lse=True)
            got = fa._launch_bwd(q, k, v, o, lse, g)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_ref(q, k, v, o, lse, g)
            scale = max(w.float().abs().max().item() for w in want)
            errs = {n: (a.float() - b.float()).abs().max().item()
                    for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            again = fa._launch_bwd(q, k, v, o, lse, g)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (all(bool(torch.isfinite(a).all()) for a in got) and bitwise
                  and max(errs.values()) <= BWD_RTOL[dtype] * scale)
            qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs)
            bound, bound_by = attention_bwd_bound_ms(q, k, dtype)
            row = dict(shape=label, layout="views", dtype=str(dtype).replace("torch.", ""),
                       q=[B, 12, L, 64], max_abs_err=max(errs.values()), errs=errs,
                       max_abs_grad=scale, rtol=BWD_RTOL[dtype], run_to_run_bitwise=bitwise,
                       ms=time_ms(lambda: fa._launch_bwd(q, k, v, o, lse, g)),
                       plain_ms=time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, g)),
                       library_ms=time_ms(lambda: torch.autograd.grad(
                           out, (qs, ks, vs), g, retain_graph=True)),
                       bound_ms=bound, bound_by=bound_by)
            log("kernel check (bwd):", json.dumps(row))
            rows.append(row)
            if not ok:
                raise SystemExit(f"flash_attention_bwd disagrees with its twin: {row}")
    return rows


def make_train_batch(device):
    """One fixed batch: 12 videos x 4 frames at 224 px (normalized noise),
    40-token captions: [DEC], the "a video of " prompt, random words, [SEP],
    pads after captions of 20-40 tokens."""
    import os

    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab

    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        tok = BlipTokenizer(vocab)
    prompt = tok.encode("a video of ")[:-1]
    prompt[0] = tok.bos_token_id
    rng = np.random.default_rng(0)
    ids = np.zeros((TRAIN_VIDEOS, TRAIN_TOKENS), np.int64)
    mask = np.zeros_like(ids)
    for b in range(TRAIN_VIDEOS):
        n = int(rng.integers(20, TRAIN_TOKENS + 1))
        row = prompt + list(rng.integers(1000, 30000, n - len(prompt) - 1)) + [tok.sep_token_id]
        ids[b, :n], mask[b, :n] = row, 1
    gen = torch.Generator(device=device).manual_seed(3)
    video = torch.randn((TRAIN_VIDEOS, TRAIN_FRAMES, 224, 224, 3), generator=gen, device=device)
    return ({"video": video, "input_ids": torch.from_numpy(ids).to(device),
             "attention_mask": torch.from_numpy(mask).to(device)}, len(prompt))


def run_training(fa, device):
    """Phase 8: the caption train step at full width for TRAIN_STEPS steps."""
    import os

    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 224, remat=False)  # the yamls' vit_grad_ckpt: False
    repo = os.path.dirname(os.path.abspath(__file__))
    med_cfg = MedConfig.from_json(os.path.join(repo, "configs", "med_config.json"),
                                  encoder_width=vit_cfg.hidden_size)
    params = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                                device, salt=1.0))
    state = create_caption_train_state(params, 1e-4, 0.05, device=device)
    del params
    batch, prompt_length = make_train_batch(device)
    step = make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, enqueue_ms, per_step = [], [], [], []
    fa.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        before = dict(fa.launch_counts)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        state, m = step(state, batch)
        end.record()
        enqueue_ms.append((time.time() - t0) * 1e3)  # host time to enqueue the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        per_step.append({k: fa.launch_counts[k] - before[k] for k in fa.launch_counts})
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    qkv_grad_max = [b["attn"]["qkv"]["kernel"].grad.abs().max().item()
                    for b in state.params["visual_encoder"]["blocks"]]
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": vit_cfg.num_layers,
            "flash_attention_bwd": vit_cfg.num_layers}
    log("training: losses", json.dumps(losses))
    log("training: launches per step", json.dumps(per_step[-1]), "in all", json.dumps(launches))
    log("training: ViT qkv kernel grad max |g| per block", json.dumps(qkv_grad_max))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training: losses not finite and falling: {losses}")
    if any(s != want for s in per_step):
        raise SystemExit(f"training: launches per step {per_step}, want {want} each")
    if not all(g > 0 for g in qkv_grad_max):
        raise SystemExit(f"training: a ViT qkv gradient is zero: {qkv_grad_max}")
    steady = statistics.median(step_ms[1:])
    prof = profile_train_step(step, state, batch)
    prof["device_busy_share"] = prof["device_ms"] / steady
    return dict(profile=prof,losses=losses, step_ms=step_ms, enqueue_ms=enqueue_ms, steady_step_ms=steady,
                steady_enqueue_ms=statistics.median(enqueue_ms[1:]),
                samples_per_s=TRAIN_VIDEOS / (steady / 1e3),
                frames_per_s=TRAIN_VIDEOS * TRAIN_FRAMES / (steady / 1e3),
                peak_memory_gib=peak / 2**30, launches=launches,
                launches_per_step=per_step[-1], videos=TRAIN_VIDEOS, frames=TRAIN_FRAMES,
                tokens=TRAIN_TOKENS, steps=TRAIN_STEPS, lr=1e-4)


def profile_train_step(step, state, batch):
    """One more step (after the counted ones) under torch.profiler: the CUDA
    kernels' device time, summed (one stream, so it is the busy time), the
    kernel launches, the top kernels by device time and the flash kernels'
    share. The profiled step's wall time is inflated by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    # a record_function range (e.g. the optimizer step) also shows as a
    # device-side row spanning its kernels; it shares its name with a host row
    host = {e.key for e in events if e.device_type != DeviceType.CUDA}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host]
    rows.sort(key=lambda r: -r[1])
    return {"profiled_wall_ms": wall_ms, "device_ms": sum(ms for _, ms, _ in rows),
            "flash_kernels_ms": sum(ms for k, ms, _ in rows if "flash_" in k),
            "kernel_launches": sum(n for _, _, n in rows),
            "top": [[k[:70], ms, n] for k, ms, n in rows[:8]]}


def in_situ_backward(fa, device):
    """Phase 9: one full-width ViT block at the trainer's shape, bf16:
    the input gradient and the qkv weight gradient through the kernels and
    through the twins (at the kernels' tiling)."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert, vit
    from vidil_tpu_torch.utils.synth import synth_tree

    cfg = ViTConfig.from_name("base", 224)
    blk = convert.from_jax_params(synth_tree({"blocks": blip.vit_shapes(cfg)["blocks"]},
                                             device, salt=1.0))["blocks"][0]
    gen = torch.Generator(device=device).manual_seed(4)
    shape = (TRAIN_VIDEOS * TRAIN_FRAMES, cfg.seq_len, cfg.hidden_size)
    x0 = torch.randn(shape, generator=gen, device=device)
    r = torch.randn(shape, generator=gen, device=device)

    def grads():
        x = x0.clone().requires_grad_(True)
        w = blk["attn"]["qkv"]["kernel"].clone().requires_grad_(True)
        p = dict(blk, attn=dict(blk["attn"], qkv=dict(blk["attn"]["qkv"], kernel=w)))
        out = vit.block_forward(p, x, cfg.num_heads, cfg.layer_norm_eps, dtype=torch.bfloat16)
        return torch.autograd.grad((out.float() * r).sum(), (x, w))

    got = grads()
    fwd, bwd = fa._forward, fa._backward
    fa._forward = lambda q, k, v, with_lse: fa.flash_attention_ref(
        q, k, v, block_k=fa.KERNEL_BLOCK_K, return_lse=with_lse)
    fa._backward = lambda q, k, v, o, lse, g: fa.flash_attention_bwd_ref(
        q, k, v, o, lse, g.to(q.dtype))
    try:
        want = grads()
    finally:
        fa._forward, fa._backward = fwd, bwd
    out = {}
    for name, a, b in zip(("dx", "d_qkv_kernel"), got, want):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"in-situ backward: non-finite {name}")
        out[f"{name}_max_abs_diff"] = (a - b).abs().max().item()
        out[f"{name}_max_abs"] = b.abs().max().item()
    return out



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))

    from vidil_tpu_torch.ops import _build
    from vidil_tpu_torch.ops import flash_attention as fa

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s for {len(libs)} libraries, nvcc in parallel")
    for name, path in libs.items():
        log(f"ptxas ({name}):", " | ".join(
            line.strip() for line in open(f"{path}.log") if "registers" in line or "spill" in line))

    rows = check_flash_kernel(fa, device)

    t0 = time.time()
    engine, vit_cfg, med_cfg = make_engine(device)
    torch.cuda.synchronize()
    log(f"engine: synthetic full-width weights on the device in {time.time() - t0:.1f} s")
    chunks = make_chunks(yuv_chunks={2, 4})
    per_chunk = 2 * vit_cfg.num_layers + med_cfg.num_layers  # two encodes + ITM layers
    results, launches, classic_calls, fps, peak = run_main_path(engine, fa, chunks, per_chunk)
    want = per_chunk * len(chunks) + med_cfg.num_layers * classic_calls
    if launches != want:
        raise SystemExit(f"kernel launches {launches}, want {want}")
    if len(results) != N_VIDEOS * len(chunks):
        raise SystemExit(f"{len(results)} results for {N_VIDEOS * len(chunks)} videos")
    for r in results:
        if not (r.unfiltered_text and all(isinstance(t, str) and t for t in r.unfiltered_text)
                and all(isinstance(t, str) for t in r.text)):
            raise SystemExit(f"bad result: {r}")
    log(f"main path: steady-state {fps:.2f} frames/s ({N_VIDEOS} videos x {N_FRAMES} frames "
        f"per chunk, first chunk excluded), peak memory {peak / 2**30:.2f} GiB, "
        f"fused-filter fallback {engine.fused_fallback_videos}/{engine.fused_total_videos} "
        f"videos, card {card}")
    log("main path: sample caption:", repr(results[-1].unfiltered_text[0]))

    for c in (0, 2):  # one RGB chunk, one YUV420 chunk
        log(f"stages (chunk {c}):", json.dumps(stage_breakdown(engine, chunks[c])))

    from vidil_tpu_torch.pipeline.capfilt import _concat_frames

    situ = in_situ_check(engine, fa, _concat_frames([c["frames"] for c in chunks[0]]),
                         vit_cfg, med_cfg)
    log("in-situ (kernel vs twin in the captioner encode):", json.dumps(situ))

    del engine
    torch.cuda.empty_cache()
    lse_rows = check_fwd_lse(fa, device)
    bwd_rows = check_bwd(fa, device)
    train = run_training(fa, device)
    log(f"training: steady step {train['steady_step_ms']:.2f} ms (CUDA events, step 1 "
        f"excluded; host enqueue {train['steady_enqueue_ms']:.2f} ms), "
        f"{train['samples_per_s']:.2f} samples/s ({TRAIN_VIDEOS} videos x "
        f"{TRAIN_FRAMES} frames), peak memory {train['peak_memory_gib']:.2f} GiB, card {card}")
    log("training:", json.dumps(train))
    prof = train["profile"]
    log(f"training profile (one step, torch.profiler): kernels {prof['device_ms']:.2f} ms on "
        f"the device, {prof['device_busy_share']:.3f} of the steady step; flash kernels "
        f"{prof['flash_kernels_ms']:.2f} ms; {prof['kernel_launches']} kernel launches")
    situ_bwd = in_situ_backward(fa, device)
    log("in-situ (kernels vs twins, one ViT block's gradients, bf16):", json.dumps(situ_bwd))

    def pick(rs, shape):
        return next(r for r in rs if r["dtype"] == "bfloat16" and r["layout"] == "views"
                    and r["shape"] == shape)

    def entry(name, source, replaces, n, rs, shape, desc, err_key="max_abs_err"):
        r = pick(rs, shape)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n,
                "max_abs_err": max(x[err_key] for x in rs if x["dtype"] == "bfloat16"),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": desc,
                "per_shape": rs}

    fwd_src = "vidil_tpu_torch/csrc/flash_attention_fwd.cu"
    record = {"kernels": [
        entry("flash_attention_fwd", fwd_src, "vidil_tpu/ops/flash_attention.py:290", launches,
              rows, "vit_self_attention",
              "q,k,v (32, 12, 577, 64) bf16 views of the QKV projection; CapFilt path"),
        entry("flash_attention_fwd_lse", fwd_src, "vidil_tpu/ops/flash_attention.py:290",
              train["launches"]["flash_attention_fwd_lse"], lse_rows, "train_224",
              "q,k,v (48, 12, 197, 64) bf16 views, with fp32 lse rows; training path"),
        entry("flash_attention_bwd", "vidil_tpu_torch/csrc/flash_attention_bwd.cu",
              "vidil_tpu/ops/flash_attention.py:242",
              train["launches"]["flash_attention_bwd"], bwd_rows, "train_224",
              "q,k,v,o,g (48, 12, 197, 64) bf16 views; training path"),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
