"""Smoke test of the PyTorch/CUDA port on one GPU: builds the port's CUDA
kernels, holds each against its plain PyTorch version at the main paths'
shapes, and drives the main paths at full BLIP-base width: CapFilt
(384 px), the caption fine-tuning step (224 px) on both ViT schedules, the
video-QA fine-tuning step with its two answer decoders, visual
tokenization with its BLIP and CLIP encoders, the prompt side on the
SBERT MPNet encoder (all-mpnet-base-v2 width), and the BLIP retrieval
eval, retrieval fine-tuning and video pretraining; then CapFilt's
sampling, on-device resize and decode variants, NLVR2, the embedding
extractor and the ViT's attention maps; then the multi-process runtime
(a world of one under NCCL, two gloo ranks on the one card); then tensor
parallelism (two gloo ranks as a 1 x 2 grid on the one card), remat
"dots" and profiling; last, the random initialisation of the JAX
package's distributions, and pretraining and captioning from it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase17-world 4   # phase 17 (b) over 4 NCCL ranks, 4 cards
    python3 chip_smoke.py --phase18-world 4   # phase 18 (a) over a 2 x 2 grid, 4 cards
    python3 chip_smoke.py --phase20           # phase 20 alone (the LM stage, its two models)

Needs a CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); imports only
vidil_tpu_torch (no JAX). Phases, each of which fails the run:
  1. card: name and power limit (nvidia-smi);
  2. build: nvcc of every kernel source (in parallel), with the build seconds
     and ptxas's registers and spills; the counts of HGMMA (wgmma), UTMALDG
     (TMA loads), SYNCS (mbarrier) and HMMA (mma.sync) instructions in the
     SASS (cuobjdump) of the bf16 flash-attention forward, which must keep
     its counts, of the bf16 flash-attention backward's two kernels, of
     every instance of the fused block's bf16 attention (K4, K5's
     recompute) and of K5's bf16 dq and dk/dv passes, each of which must
     hold HGMMA, UTMALDG and SYNCS and no HMMA, and of every bf16 GEMM
     instance of K3, K4 and K5
     (csrc/gemm_sm90.cuh), each of which must hold HGMMA and UTMALDG;
  3. kernel check: the flash-attention kernel (K1) against its twin at the
     ViT self-attention shape (32, 12, 577, 64) and the grouped-ITM fold
     (q (32, 12, 96, 64) over k/v (32, 12, 577, 64)), bf16 and fp32, on
     contiguous tensors and on the main path's strided views, bitwise run to
     run, with the times of the kernel, the twin and
     F.scaled_dot_product_attention (timed as a yardstick only), the
     kernel's TFLOP/s, share of its bound and share of real work in its
     padded tiles, and its wrapper's host us per call (and, at the ViT
     views, its C entry's alone);
  3b. the decode's cross-attention kernel (K6) against its plain version at
     CapFilt's beam step (q (96, 1, 768) over k/v (32, 12, 577, 64) views),
     prefill (4 prompt tokens) and one-row shape, bf16 and fp32, each call
     on the next of 12 layers' memory, bitwise run to run, with the times of
     the kernel, the plain version and F.scaled_dot_product_attention on
     the beam-replicated K/V (a yardstick only), its device ms and bound;
  4. main path: CapFiltEngine.dispatch_chunk / complete_chunk over chunks of
     8 videos x 4 frames (RGB and YUV420), synthetic full-width weights,
     bf16, beam_group_kv and the fused filter; the kernel's launch count
     must show it ran in both encodes (the reference's gate keeps the ITM's
     attention on the plain path), and K6's that it ran in every layer of
     the decode's prefill and steps: 12 x 16 launches in the first chunk
     (eager), twice that in the second (its capture), none in the replayed
     ones, where one more chunk under torch.profiler must show the kernel
     12 x 16 times (less the records the profiler loses in a replay);
  5. stage breakdown of one RGB and one YUV420 chunk (host clock, synced);
  6. in-situ checks (reported, not pass bars): the captioner encode through
     K1 and through its twin (one block and twelve, bf16 and fp32, and the
     caption token agreement); the same encode with use_fused_block (K4 per
     block) against the classic one;
  7. training attention kernels: K1 with logsumexp rows against its twin at
     the ViT shapes and the 224-px trainer's (48, 12, 197, 64), with the
     rates of phase 3 and bitwise run to run; the
     backward kernel (K2) against its twin at (48, 12, 197, 64) and
     (32, 12, 577, 64), bf16 and fp32, run to run bitwise, with its device
     ms and SDPA backward's (torch.profiler) and its TFLOP/s by device time
     over the 7 products it runs and the 5 of the bound;
  8. fused ViT block: K4 against fused_block_ref at the trainers' block
     (48, 256, 768), 197 true tokens, and the CapFilt encode's (32, 640,
     768), 577 true tokens; K5 against fused_block_bwd_ref (dx and the 12
     gradients) at both; both run to run bitwise; bf16 and fp32;
     with the times of the kernel, the twin and a library block
     (F.layer_norm, F.linear, SDPA, F.gelu; a yardstick only); and, from
     torch.profiler, each call's device ms beside the library block's, its
     launches by part (GEMMs, attention passes, LN rows, column sums,
     split-K sums) and its GEMMs' TFLOP/s; then the block's attention
     launch alone (K4's, and with its statistics K5's recompute) against
     its twin at both shapes, bf16 and fp32, run to run bitwise, beside
     SDPA with the key mask; then K5's attention backward alone (its dq and
     dk/dv passes with dbqkv) against block_attention_bwd_ref at both
     shapes, bf16 and fp32, run to run bitwise, with its device ms beside
     its bound and SDPA backward's, and its TFLOP/s;
  9. caption training at full width (ViT-B/16 224 px, MED from
     configs/med_config.json), synthetic weights, one fixed batch of 12
     videos x 4 frames with 40-token captions, bf16, MED remat on: 4 steps
     of the classic schedule (VIDIL_TPU_TRAIN_FUSED_BLOCK=0: at 224 px the
     reference's gate sends the attention to the plain path, so no K1 or K2
     launch) and 8 of the default fused one
     (exactly 12 K4 and 12 K5 launches per step, no K1/K2): finite losses,
     the last below the first, non-zero ViT qkv gradients in every block;
     steady step ms (CUDA events), host enqueue ms, samples/s, peak memory
     and one profiled step each;
 10. VQA training: make_vqa_train_step at full width (ViT-B/16 224 px with
     vit_grad_ckpt, MED-base encoder and decoder), 8 questions x 4 frames,
     35-token questions, 1-3 answers of 12 tokens each, 8 steps, with the
     checks of phase 9 (12 K4 + 12 K5 per step); then vqa_generate_ids and
     rank_answer (k = 128 over 256 answers) must give well-formed answers;
 11. in-situ backward checks (reported): one classic ViT-B/384 block over
     32 frames x 577 tokens, whose attention passes the gate (exactly one
     K1-with-lse and one K2 launch, else the run fails), its input and qkv
     weight gradients through K1/K2 and through their twins; one fused
     224-px block's through K4/K5 and through theirs;
 12. fused MLP: K3 against fused_mlp_ref at the visual-tokenization ViT
     encode's (36928, 768) -> 3072 and the ITM block's (8192, 768) -> 3072,
     bf16 and fp32, run to run bitwise, with the times of the kernel, the
     plain version and F.linear + F.gelu + F.linear (a yardstick only), and
     from torch.profiler the device ms of both and each GEMM's TFLOP/s;
 13. visual tokenization at full width, synthetic weights, bf16, over the
     vendored vg ontology in full: the BLIP engine (ViT-B/384 + MED-base with
     vision_proj/text_proj/itm_head, use_fused_mlp in both towers, k_test
     128, top 5, prompts v1) and the CLIP engine (ViT-L/14, byte-level
     synthetic BPE), two chunks of 8 videos x 8 noise frames each (the first
     warms up); every video must get 8 frames x 4 categories x 5 ontology
     terms, and K3 and K1 must launch exactly the times the shapes give
     (no K1 in the CLIP engine: its 257-token attention fails the gate);
     frames/s, ontology-embedding and rerank seconds, peak memory. Reported
     with it (phase 6's engine): the CapFilt captioner encode with
     use_fused_mlp against the encode without, after one block and twelve.
 14. the prompt side at full width: a synthetic all-mpnet-base-v2 snapshot
     (sin-fill weights as an HF-keyed pytorch_model.bin, config.json, the
     30527-line vocab) read by the in-context CLI's own route
     (generate_prompts_random_prefix_in_context_selection.main, bf16, on
     the card): caption selection (SHOT 10, N 5, --comparing_target
     caption) over 1000 synthetic query videos of 8 frames, QA selection
     (SHOT 5, N 5, --comparing_target question) over 1000 questions, the QA
     answer mapping of 4096 predictions onto 1500 answers in batches of 64,
     VLEP multichoice over 500 examples of 2 events; every embedding finite,
     768 wide and of norm 1 within 1e-3, one prompt per query holding the
     instruction, the N examples and the query, the idx map the queries',
     no launch of a TPU kernel's port (MPNet's biased attention and FFN
     are plain, as in the reference), and the card's fp32 encode of one 64 x
     128 batch within 4x the CPU's own fp32 error (against an fp64 forward)
     of the CPU's fp32 encode; reported: the 64 x 128 batch's ms,
     sentences/s, device ms and launches, the single-sentence encode's ms,
     host enqueue ms, device ms and launches, per-query selection ms,
     answer-mapping and VLEP seconds, peak memory, and the bf16 top-N
     selection's agreement with the fp32 one.
 15. retrieval and pretraining at full width (ViT-B/16 224 px, MED-base),
     synthetic weights, bf16: the retrieval eval (RetrievalEvaluator at the
     shipped yaml's k_test 64, 8 frames, 8 rows per block, 8 blocks per
     dispatch, self_fold 8) over 1000 noise videos x 1 synthetic caption,
     every rank row keeping exactly 64 finite scores above -100, K1
     launched exactly 12 times per dispatched rerank block (v2t and the
     t2v bucket plan) and nothing else; one dispatch profiled (host
     enqueue, device ms), the eval's dispatch loop timed (wall, device
     ms, busy share), K1 at the block's fold by device time (in the
     dispatch, and back to back beside SDPA), and one block in situ (each
     K1 launch against its twin on the same inputs, within ATOL x max(1,
     max |o|); the block's ITM logits through K1 no further from the
     twin's than WITNESS_FACTOR x those through SDPA or an fp32
     attention); then 6 retrieval train steps
     (batch 8 x 4 frames, 35 tokens, queues of 57600, vit_grad_ckpt: no
     kernel launch, the queue pointer advancing by 8 a step) and 6
     pretraining steps (30 tokens, bert_config.json's MED widened to the
     tokenizer: 24 K4 + 12 K5 a step), with step ms, host enqueue ms,
     busy share, samples/s and peak memory, and one pretraining block
     through K4/K5 against the twins.
 16. CapFilt's other modes and the remaining BLIP model functions at full
     width (BLIP-base/384, synthetic weights, bf16, chunks of 8 videos x 4
     frames), each path with every launch count zeroed just before it and
     read just after (exactly 24 K1 a CapFilt chunk, 12 an encode, nothing
     else): nucleus sampling (top_p 0.9, repetition penalty 1.1) through
     dispatch_chunk / complete_chunk, well-formed, identical across two
     runs with one seed and different with another, its decode seconds
     beside the beam decode's; resize_on_device at 240x320 and 480x640, RGB
     and YUV420: the card's resize within 1 uint8 level (on rounding ties,
     counted) of the port's CPU resize, against the host PIL path and the
     encode seconds both ways (reported), one native chunk through the
     engine; decode_layer_unroll and decode_lazy_reorder, each and both: token-identical to the stock
     decode in fp32, bf16 agreement and decode seconds (reported); NLVR2
     forward and loss over 16 pairs (35-token texts, fusion_layer 6) and
     blip_embedding_forward (itm, itc) over 32 images: finite, shaped, ITC
     features of unit norm (fp32 within 1e-3, bf16 within 2**-7), and the
     return_attn encode (no K1): 12 maps whose rows sum to 1 within 1e-3,
     its embeddings beside the classic encode's after one block and twelve
     (reported).
 17. the multi-process runtime: the ViT-B/384 encode of 32 frames with
     use_flash False (0 K1 launches; 12 with it); (a) the fused caption
     step of phase 9 without a process group, then in a world of one under
     NCCL through init_distributed_mode (torchrun's variables) with the
     gradient all-reduce, and with ZeRO-1, each bitwise equal to the plain
     step (loss, parameters, first moments; 12 K4 + 12 K5 each); (b) two
     gloo ranks on cuda:0 (this script in two fresh processes, env
     rendezvous): the caption step (12 K4 + 12 K5 per rank) and phase 15's
     retrieval step (no launch) at the global batch, each rank on its rows
     (the trainers' loader split), against one process (the loss within
     P17_LOSS_RTOL, the summed gradient within P17_GRAD_NORM_REL of its norm
     and every leaf within P17_GRAD_LEAF_REL of its norm; the
     retrieval step on the ranks' draws, which must agree across ranks), the
     sharded rerank (30 videos, k_test 16; 12 K1 per dispatched block of
     each rank) against the one process's scores within P17_SCORE_REL, and
     the CapFilt CLI (7 videos x 4 frames, 4 a chunk, BLIP-base/384, bf16;
     24 K1 per rank and per chunk of the one process) with its merged
     files byte-identical to one process's. With --phase17-world N, (b)
     alone over N NCCL ranks, one card each (at N = 4: 2 videos x 8
     frames a chunk, 36 K1 a chunk).
 18. tensor parallelism, remat "dots" and profiling: (a) two gloo ranks
     on cuda:0 as a 1 x 2 (data, model) grid run P18_STEPS caption steps
     (ViT-B/16 384 px, MED-base, bf16, 4 videos x 4 frames) on each ViT
     schedule, then one fp32 step: the classic one
     (VIDIL_TPU_TRAIN_FUSED_BLOCK=0), each rank on 6 of 12 heads, per step
     exactly 12 K1 with lse rows and 12 K2, all at q (16, 6, 577, 64)
     (phase 7 holds both kernels there against their twins, run-to-run
     bitwise); the default fused one, each block whole on every rank's
     gathered weights as in the reference, per step exactly 12 K4 and 12
     K5 at x (16, 640, 768) and no K1 or K2, each block's whole gradient
     bitwise equal across the ranks before it is sliced; on both, the two
     ranks' losses bitwise equal, the first step's loss and gathered
     gradients against one process at the P18 bars; parameter bytes and
     peak memory per rank and step ms are printed. (b) The classic step in
     one process with the ViT's and MED's remat full and then "dots": the
     gradients bitwise
     equal; peak memory and step ms of each. (c) utils/profiling.trace
     around one CapFilt chunk inside an annotate range: the trace names K1's
     kernel and the range; device_memory_stats(). With --phase18-world N,
     (a) alone over N NCCL ranks, one card each, an N/2 x 2 grid.
 19. from-scratch initialisation: (a) init_pretrain_params at
     pretrain_video.yaml's model (ViT-B/16 224 px, bert_config.json's MED
     widened to 30524 ids) and init_clip at ViT-L/14, fp32, CUDA
     generators, with the parameter counts and seconds: constant leaves
     exact, every truncated leaf within 2 sigma and its std within 1% of
     0.8796 sigma (6 standard errors for a leaf too small for 1%), every
     plain-normal leaf's within 1% of sigma; create_pretrain_state's own
     draw from the seed the same tree bit for bit; (c) on the init, the
     ViT-B/384 encode of a chunk's 32 frames through K1 (12 launches)
     against its twin, bf16 and fp32, and with use_fused_block (K4, 12
     launches) against the classic one, and one fused pretraining step's
     gathered ViT gradients (24 K4 + 12 K5) against fused_block_ref /
     fused_block_bwd_ref, each by relative Frobenius distance within 12
     units of its dtype (twice that for the gradients) times the growth
     of a 1e-3 pixel perturbation from 1 block to 12 measured in the run
     (P19_UNIT); (b) 6 pretraining steps from the init on phase 15's
     batch, bf16, fused: 24 K4 + 12 K5 a step, finite losses, the first
     step's loss_itm and loss_lm within p19_loss_bars, loss_lm falling,
     the median step ms; (d) CapFiltEngine.caption_frames over 32 frames
     at 384 px through the init captioner: 32 strings, 12 K1 launches,
     the same run to run, sample mode fixed by its seed and changed by
     another;
 20. the LM stage (`pipeline/lm_answer.py`) on its two models,
     NVIDIA-Nemotron-3-Nano-30B-A3B and Kimi-Linear-48B-A3B-Instruct (one
     card's share of a two-card expert-parallel deployment: 128 held of
     the router's 256 experts): (a) K7 (`grouped_expert_gemm`) against
     grouped_expert_gemm_ref at each model's prefill and decode shapes:
     Nemotron's 36,000 tokens top 6 of 128 experts (216,000 routed rows,
     ~1.7k an expert) and 16 tokens (96 rows over ~69 experts), up (2688
     -> 1856, relu^2) and down (1856 -> 2688, stored); Kimi's 36,400
     tokens top 8 of 256 (291,200 routed rows, about half of them in the
     bucket past offsets[128], which no launch reads or writes) and 16
     tokens (128 rows), up (2304 -> 2 x 1024 interleaved, SwiGLU into
     1024) and down (1024 -> 2304, stored); on the held rows within 2 bf16
     ulps of max|want|, bitwise run to run, with its time, device time,
     bound (operations at the bf16 peak or bytes at HBM's, from the held
     rows, the output's columns and the experts hit) and a per-expert
     F.linear loop's time (library_ms); (b) LMAnswerEngine, for each
     model in turn (peaks of 60-70 GB), over four chunks of 16 synthetic
     prompts of 1500-3000 tokens at full size, seeded weights: K7's
     launches a chunk, reset to zero first, must be 2 x 23 (Nemotron) or
     2 x 26 (Kimi) a pass (a prefill or an eager decode step): 32 passes
     in the eager first chunk, the prefill and twice the 31 steps in the
     capture, the prefill alone in each replay; one more replayed chunk
     under torch.profiler must show the 32 passes' grouped_gemm_bf16
     kernels (less the records the profiler loses in a replay); K8's
     launches a chunk must be 23 in Nemotron's (one a Mamba layer of the
     prefill, in every chunk) and none in Kimi's; (c) K8 (`ssd.ssd_chunked`
     on the card) against `ssd_chunked_ref` at one Mamba layer of a
     benchmark chunk's packing (16 prompts of 1500-3000 tokens, H 64, P 64,
     G 8, N 128), within twice the float32 limit of
     tests/test_torch_ssd_scan.py, bitwise run to run, with its time,
     device time, bound (its bytes at HBM's rate, or its products at three
     bf16 terms each at the bf16 peak) and the plain version's time.
Phase 3 also holds K1 at the visual-tokenization shapes (CLIP-L vision, the
BLIP ITM fold) and at the retrieval rerank's fold (its text length from
phase 15's corpus). Kernel times ("ms", "plain_ms", "library_ms") are the median
of single calls between CUDA events on an idle card: device time plus the
host work before the launch; "device_ms" (phases 3 at the ViT views, 8,
12) is device time alone. The last two lines are the kernels' JSON record (each kernel at its main
path's shape, bf16; every shape and dtype is on its own "kernel check"
line above) and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from vidil_tpu_torch.utils.profiling import device_profile

# H100 SXM data sheet (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# kernel vs twin at the kernel's own tiling: only the fp32 summation order
# differs, which can move a bf16 rounding by one ulp (|o| < 1 here)
ATOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}

N_VIDEOS, N_FRAMES, N_CHUNKS = 8, 4, 5  # chunk 0 warms up; 1.. are steady state
REPS = 20
# visual tokenization (pipeline_config_msrvtt_train.yaml: videos_per_batch 8,
# num_frm_visual_tokenization 8, k_test 128, topk_visualize 5); the BLIP
# rerank scores VT_ITM_ROWS frames per call
VT_VIDEOS, VT_FRAMES, VT_K_TEST, VT_TOPK, VT_ITM_ROWS = 8, 8, 128, 5, 4
# retrieval eval (train_blip_video_retrieval_msrvtt_pseudo.yaml: num_frm_test
# 8, k_test 64, 224 px; the evaluator's rows_per_batch 8 and
# blocks_per_dispatch 8) over MSR-VTT 1k-A's size, 1000 videos x 1 caption
RET_VIDEOS, RET_FRAMES, RET_K, RET_ROWS, RET_BLOCKS = 1000, 8, 64, 8, 8
RET_REAL_DISPATCHES = 3  # the eval's dispatch loop, timed on its own
# the in-situ rerank block's ITM logits: K1's distance from the twin's within
# this factor of the farther of two bf16 witnesses' (SDPA; fp32 attention
# rounded once). Their distances scatter with where the first differing
# rounding falls, not with the kernel, so the bar leaves room for that
# scatter; a fault in K1 moves its logits by more than any bf16 rounding
WITNESS_FACTOR = 3.0
# the retrieval fine-tune (the yaml's batch_size_train 8, num_frm_train 4,
# queue_size 57600, vit_grad_ckpt) and pretraining (pretrain_video.yaml's
# batch_size 8, num_frm_train 4, 30-token captions)
RET_TRAIN_BATCH, RET_TRAIN_FRAMES, RET_QUEUE, RET_STEPS = 8, 4, 57600, 6
PRE_TOKENS = 30


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


def back_to_back_ms(fn, n=50) -> float:
    """CUDA-event ms per call over n calls issued back to back after warm-up:
    the device time per call once the launches queue faster than they run."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn) -> float:
    """Host microseconds per call of fn over REPS calls issued back to back
    after warm-up, the card left to run them afterwards: the enqueue cost
    (the wrapper's checks, tensor maps, launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / REPS * 1e6


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


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA")
# K1's counts in each bf16 instance of its wgmma + TMA kernel (moving its
# PTX wrappers into csrc/sm90.cuh left them as they were)
K1_SASS = {"HGMMA": 13, "UTMALDG": 3, "SYNCS": 24, "HMMA": 0}
# the bf16 attention kernels on wgmma + TMA, by library: K2's two passes,
# the fused block's attention (6 instances: with and without statistics, at
# 1, 2 or more key chunks) and K5's own dq and dk/dv passes
WGMMA_ATTENTION = {"flash_attention_bwd": (("flash_bwd_dq_bf16", 1), ("flash_bwd_dkdv_bf16", 1)),
                   "fused_vit_block_fwd": (("attn_fwd_wgmma", 6),),
                   "fused_vit_block_bwd": (("attn_fwd_wgmma", 6), ("attn_bwd_dq_wgmma", 1),
                                           ("attn_bwd_dkdv_wgmma", 1))}
# the mma.sync attention kernels these replaced (the block attention's, then
# K5's two passes): none may come back
MMA_SYNC_ATTENTION = ("attn_fwd_bf16", "attn_bwd_dq_bf16", "attn_bwd_dkdv_bf16")
# the bf16 GEMM (csrc/gemm_sm90.cuh) in the libraries of K3, K4 and K5
GEMM_LIBS = ("fused_mlp_fwd", "fused_vit_block_fwd", "fused_vit_block_bwd")


def _sass_label(kernel, name):
    """A short label for a mangled kernel name: K1's instance by its lse
    flag; a GEMM instance by its tile width, operand majors and epilogue."""
    if kernel == "flash_fwd_bf16":
        return f"{kernel}<{'lse' if 'ILb1E' in name else 'no lse'}>"
    if kernel.startswith(("flash_bwd_", "attn_bwd_")):
        return kernel
    if kernel == "attn_fwd_wgmma":
        m = re.search(r"ILb([01])ELi(\d)E", name)
        passes = "3 passes" if m[2] == "0" else f"1 pass, {m[2]} chunk(s)"
        return f"{kernel}<{'stats' if m[1] == '1' else 'no stats'}, {passes}>"
    m = re.search(r"ILi(\d+)ELb([01])ELb([01])EN9vit_block8BlockEpiILi(\d)E", name)
    return f"{kernel}<bn={m[1]},mn_a={m[2]},mn_b={m[3]},epi={m[4]}>" if m else name


def sass_counts(lib, kernel="flash_fwd_bf16"):
    """Counts of HGMMA (wgmma), UTMALDG (TMA tile loads) and SYNCS (mbarrier)
    instructions in the SASS of each function of a built library whose name
    holds `kernel` (cuobjdump -sass, beside nvcc in the toolkit)."""
    from vidil_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel in name:
            counts[_sass_label(kernel, name)] = {ins: len(re.findall(rf"\b{ins}\b", part))
                                                for ins in SASS_OPS}
    return counts


def check_sass(libs):
    """Phase 2's SASS checks: both bf16 K1 instances keep their wgmma, TMA
    and mbarrier counts; K2's two bf16 kernels and every instance of the
    fused block's bf16 attention and K5's bf16 dq and dk/dv passes run wgmma
    from TMA loads on mbarriers, with no mma.sync left (MMA_SYNC_ATTENTION,
    the kernels they replaced); every
    bf16 GEMM instance of K3, K4 and K5 runs wgmma from TMA loads; no
    mma.sync GEMM is left (its kernel was vit_block::gemm_bf16)."""
    sass = {"flash_attention_fwd": sass_counts(libs["flash_attention_fwd"])}
    log("sass (flash_attention_fwd, bf16 kernel):", json.dumps(sass["flash_attention_fwd"]))
    if len(sass["flash_attention_fwd"]) != 2 or any(
            c != K1_SASS for c in sass["flash_attention_fwd"].values()):
        raise SystemExit(f"the bf16 flash-attention forward's SASS changed: {sass}, want "
                         f"{K1_SASS} per instance")
    for lib, kernels in WGMMA_ATTENTION.items():
        for kernel, instances in kernels:
            got = sass_counts(libs[lib], kernel)
            sass[f"{lib}:{kernel}"] = got
            log(f"sass ({lib}, {kernel}):", json.dumps(got))
            old = {k: c for name in MMA_SYNC_ATTENTION
                   for k, c in sass_counts(libs[lib], name).items()}
            if len(got) != instances or old or not all(
                    c["HGMMA"] and c["UTMALDG"] and c["SYNCS"] and not c["HMMA"]
                    for c in got.values()):
                raise SystemExit(f"{lib}: a bf16 attention kernel runs without wgmma, TMA or "
                                 f"mbarriers, or with mma.sync: {got} (want {instances} "
                                 f"instances), mma.sync attention {list(old)}")
    for name in GEMM_LIBS:
        sass[name] = sass_counts(libs[name], "gemm_bf16")
        log(f"sass ({name}, bf16 GEMM instances):", json.dumps(sass[name]))
        old = sass_counts(libs[name], "vit_block9gemm_bf16")
        if not sass[name] or old or not all(c["HGMMA"] and c["UTMALDG"]
                                            for c in sass[name].values()):
            raise SystemExit(f"{name}: a bf16 GEMM runs without wgmma or TMA: {sass[name]}, "
                             f"mma.sync GEMMs {list(old)}")
    return sass


# phase 3/7 fields that K1's record entries carry as well
RATE_KEYS = ("tflops", "bound_share", "tile_use", "host_us")


def c_entry_host_us(fa, q, k, v) -> float:
    """Host us per call of the forward's C entry alone (ctypes, for bf16 the
    three tensor maps, the launch), the Python wrapper left out: bf16 minus
    fp32 at one shape is what encoding the maps costs."""
    fn = fa._kernel_fns()["fwd"]
    o = torch.empty_like(q)  # held until host_us has synchronized
    args = fa._fwd_args(q, k, v, o, None, torch.cuda.current_stream().cuda_stream)

    def call():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd C entry failed: cudaError {err}")

    return host_us(call)


def attention_rates(fa, q, k, ms, bound):
    """Achieved TFLOP/s of the call's 4*B*H*Lq*Lk*D operations, the share
    of the least time (bound / ms), and the share of the kernel's tiles'
    work (query tiles x key tiles, padded) that is real."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    q_tiles, k_tiles, _ = fa.kernel_tiles(Lq, Lk, q.dtype)
    padded = q_tiles * fa.KERNEL_BLOCK_M[q.dtype] * k_tiles * fa.KERNEL_BLOCK_K[q.dtype]
    return {"tflops": 4 * B * H * Lq * Lk * D / (ms * 1e-3) / 1e12, "bound_share": bound / ms,
            "tile_use": Lq * Lk / padded}


def _main_path_views(label, gen, device, dtype, text_len=None):
    """q, k, v as the main path hands them to the kernel: head-split views
    of projection outputs (no copies). vit: one fused QKV projection of 32
    frames x 577 tokens; itm: 4 texts x 24 tokens per frame, folded into 96
    query rows over the frame's 577-token memory."""
    from vidil_tpu_torch.models.layers import split_heads

    H = 12
    if label == "vit_self_attention":
        qkv = torch.randn((32, 577, 3 * 768), generator=gen, device=device).to(dtype)
        return tuple(split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    if label == "vt_clip_vision":  # CLIP-L's separate q, k, v projections
        return tuple(split_heads(torch.randn((64, 257, 1024), generator=gen, device=device)
                                 .to(dtype), 16) for _ in range(3))
    # the grouped ITM: G texts of T tokens per memory fold into G*T query
    # rows; the retrieval rerank's memory is a video's 8 frames x 197
    # tokens, its texts text_len tokens long
    B, G, T, Lk = {"itm_grouped_fold": (32, 4, 24, 577),
                   "vt_itm_fold": (VT_ITM_ROWS, VT_K_TEST, 16, 577),
                   "retrieval_rerank_fold": (RET_ROWS, RET_K, text_len,
                                             RET_FRAMES * 197)}[label]
    q = split_heads(torch.randn((B * G, T, 768), generator=gen, device=device).to(dtype), H)
    q = q.reshape(B, G, H, T, 64).transpose(1, 2).reshape(B, H, G * T, 64)
    k = split_heads(torch.randn((B, Lk, 768), generator=gen, device=device).to(dtype), H)
    v = split_heads(torch.randn((B, Lk, 768), generator=gen, device=device).to(dtype), H)
    return q, k, v


def check_flash_kernel(fa, device, rerank_len):
    """Phase 3: kernel vs twin at the main paths' shapes, bf16 and fp32, on
    contiguous tensors and on the strided views the main path passes;
    `rerank_len` is the retrieval corpus's text length."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = {"vit_self_attention": ((32, 12, 577, 64), (32, 12, 577, 64)),
              "itm_grouped_fold": ((32, 12, 96, 64), (32, 12, 577, 64)),
              "vt_clip_vision": ((64, 16, 257, 64), (64, 16, 257, 64)),
              "vt_itm_fold": ((VT_ITM_ROWS, 12, VT_K_TEST * 16, 64), (VT_ITM_ROWS, 12, 577, 64)),
              "retrieval_rerank_fold": ((RET_ROWS, 12, RET_K * rerank_len, 64),
                                        (RET_ROWS, 12, RET_FRAMES * 197, 64))}
    for dtype in (torch.bfloat16, torch.float32):
        for label, (qs, ks) in shapes.items():
            for layout in ("contiguous", "views"):
                if layout == "views":
                    q, k, v = _main_path_views(label, gen, device, dtype, rerank_len)
                else:
                    q = torch.randn(qs, generator=gen, device=device).to(dtype)
                    k = torch.randn(ks, generator=gen, device=device).to(dtype)
                    v = torch.randn(ks, generator=gen, device=device).to(dtype)
                got = fa.flash_attention(q, k, v)
                bitwise = torch.equal(got, fa.flash_attention(q, k, v))
                torch.cuda.synchronize()
                want = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype])
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= ATOL[dtype] and bitwise
                bound, bound_by = attention_bound_ms(q, k, dtype)
                twin = lambda: fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype])
                kernel = lambda: fa.flash_attention(q, k, v)
                row = dict(shape=label, layout=layout, dtype=str(dtype).replace("torch.", ""),
                           q=list(q.shape), kv=list(k.shape), max_abs_err=err, atol=ATOL[dtype],
                           run_to_run_bitwise=bitwise, ms=time_ms(kernel),
                           plain_ms=time_ms(twin),
                           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                           bound_ms=bound, bound_by=bound_by)
                row.update(attention_rates(fa, q, k, row["ms"], bound), host_us=host_us(kernel))
                if label == "vit_self_attention" and layout == "views":
                    row["c_entry_host_us"] = c_entry_host_us(fa, q, k, v)
                    # device time alone (torch.profiler), beside SDPA's
                    row["device_ms"], row["device_kernels"] = device_profile(kernel)
                    row["library_device_ms"], _ = device_profile(
                        lambda: F.scaled_dot_product_attention(q, k, v))
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


def run_main_path(engine, fa, da, chunks, per_chunk):
    """Phase 4: dispatch/complete with one chunk in flight, as the CLI does.
    Returns (results, launches, K6's launches by chunk, classic filter
    calls, steady frames/s, peak bytes)."""
    from vidil_tpu_torch.ops.image import YUV420Frames

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    da.reset_launch_counts()
    results, t_steady, frames_steady = [], None, 0
    in_flight = None
    classic_calls = 0
    k6_launches = []
    for chunk in chunks + [None]:
        if chunk is not None:
            before = fa.launch_counts["flash_attention_fwd"]
            k6_before = da.launch_counts["decode_cross_attention"]
            d = engine.dispatch_chunk(chunk, CONFIG)
            got = fa.launch_counts["flash_attention_fwd"] - before
            k6_launches.append(da.launch_counts["decode_cross_attention"] - k6_before)
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
        f"filter fallback call, {launches} kernel launches, K6 launches by chunk "
        f"{k6_launches}")
    return (results, launches, k6_launches, classic_calls, fps,
            torch.cuda.max_memory_allocated())


def profile_k6_chunk(engine, da, chunk):
    """One more main-path chunk (its decode replayed from the engine's CUDA
    graphs) under torch.profiler: K6's kernel records in the trace, and the
    launches its wrapper counted (none: the graphs hold them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    da.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.complete_chunk(engine.dispatch_chunk(chunk, CONFIG))
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and "decode_cross_attention" in e.key)
    return {"profiled_kernels": kernels,
            "wrapper_launches": da.launch_counts["decode_cross_attention"]}


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

    def twin(q, k, v, use_flash=True, grid=(1, 1)):
        return fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype])

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
CLASSIC_STEPS = 4  # the opted-out schedule: fewer steps, to keep the run short


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


def _train_views(B, L, gen, device, dtype, heads=12):
    """q, k, v as head-split views of one QKV projection and g as the head
    split of a merge_heads gradient, as the train step hands them over
    (`heads` of 64: a tensor-parallel rank's local heads)."""
    from vidil_tpu_torch.models.layers import split_heads

    qkv = torch.randn((B, L, 3 * 64 * heads), generator=gen, device=device).to(dtype)
    q, k, v = (split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    g = split_heads(torch.randn((B, L, 64 * heads), generator=gen, device=device).to(dtype),
                    heads)
    return q, k, v, g


# phase 18's tensor-parallel rank: ViT-B/384 at 4 videos x 4 frames on 6 of
# 12 heads (tp = 2), fp32 logits 127.8 MB: K1 runs only on the gate's
# global 12 heads (255.7 MB)
TP_SHAPE = ("train_384_tp", 16, 577, 6)


def check_fwd_lse(fa, device):
    """Phase 7a: the forward with lse rows vs its twin, and its time
    against the inference launch on the same inputs."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L, H in (("vit_self_attention", 32, 577, 12), ("train_224", 48, 197, 12),
                               TP_SHAPE):
            for layout in ("contiguous", "views"):
                q, k, v, _ = _train_views(B, L, gen, device, dtype, H)
                if layout == "contiguous":
                    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                o, lse = fa._launch(q, k, v, with_lse=True)
                o2, lse2 = fa._launch(q, k, v, with_lse=True)
                bitwise = torch.equal(o, o2) and torch.equal(lse, lse2)
                torch.cuda.synchronize()
                want_o, want_lse = fa.flash_attention_ref(
                    q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype], return_lse=True)
                err = (o.float() - want_o.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                ok = (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
                      and err <= ATOL[dtype] and lse_err <= LSE_ATOL[dtype] and bitwise)
                bound, bound_by = attention_bound_ms(q, k, dtype, with_lse=True)
                kernel = lambda: fa._launch(q, k, v, with_lse=True)
                row = dict(shape=label, layout=layout, dtype=str(dtype).replace("torch.", ""),
                           q=[B, H, L, 64], max_abs_err=err, lse_max_abs_err=lse_err,
                           atol=ATOL[dtype], lse_atol=LSE_ATOL[dtype], run_to_run_bitwise=bitwise,
                           ms=time_ms(kernel),
                           inference_ms=time_ms(lambda: fa._launch(q, k, v)),
                           plain_ms=time_ms(lambda: fa.flash_attention_ref(
                               q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype], return_lse=True)),
                           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                           bound_ms=bound, bound_by=bound_by)
                row.update(attention_rates(fa, q, k, row["ms"], bound), host_us=host_us(kernel))
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
        for label, B, L, H in (("train_224", 48, 197, 12), ("train_384", 32, 577, 12), TP_SHAPE):
            q, k, v, g = _train_views(B, L, gen, device, dtype, H)
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
            kernel = lambda: fa._launch_bwd(q, k, v, o, lse, g)
            library = lambda: torch.autograd.grad(out, (qs, ks, vs), g, retain_graph=True)
            dev_ms, kernels = device_profile(kernel)
            flops = 2 * B * H * L * L * 64  # one product
            row = dict(shape=label, layout="views", dtype=str(dtype).replace("torch.", ""),
                       q=[B, H, L, 64], max_abs_err=max(errs.values()), errs=errs,
                       max_abs_grad=scale, rtol=BWD_RTOL[dtype], run_to_run_bitwise=bitwise,
                       ms=time_ms(kernel),
                       plain_ms=time_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, g)),
                       library_ms=time_ms(library), bound_ms=bound, bound_by=bound_by,
                       device_ms=dev_ms, library_device_ms=device_profile(library)[0],
                       tflops_7_products=7 * flops / (dev_ms * 1e-3) / 1e12,
                       tflops_5_products=5 * flops / (dev_ms * 1e-3) / 1e12,
                       kernels={re.sub(r"\(anonymous namespace\)::", "", k).split("(")[0]: v
                                for k, v in kernels.items()})
            log("kernel check (bwd):", json.dumps(row))
            rows.append(row)
            if not ok:
                raise SystemExit(f"flash_attention_bwd disagrees with its twin: {row}")
    return rows


def make_train_batch(device, videos=TRAIN_VIDEOS, frames=TRAIN_FRAMES, size=224):
    """One fixed batch: 12 videos x 4 frames at 224 px (normalized noise;
    or `videos` x `frames` at `size`), 40-token captions: [DEC], the "a
    video of " prompt, random words, [SEP], pads after captions of 20-40
    tokens."""
    import os

    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab

    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        tok = BlipTokenizer(vocab)
    prompt = tok.encode("a video of ")[:-1]
    prompt[0] = tok.bos_token_id
    rng = np.random.default_rng(0)
    ids = np.zeros((videos, TRAIN_TOKENS), np.int64)
    mask = np.zeros_like(ids)
    for b in range(videos):
        n = int(rng.integers(20, TRAIN_TOKENS + 1))
        row = prompt + list(rng.integers(1000, 30000, n - len(prompt) - 1)) + [tok.sep_token_id]
        ids[b, :n], mask[b, :n] = row, 1
    gen = torch.Generator(device=device).manual_seed(3)
    video = torch.randn((videos, frames, size, size, 3), generator=gen, device=device)
    return ({"video": video, "input_ids": torch.from_numpy(ids).to(device),
             "attention_mask": torch.from_numpy(mask).to(device)}, len(prompt))


def _counts(fa, fvb):
    return {**fa.launch_counts, **fvb.launch_counts}


def train_loop(label, step, state, batch, steps, fa, fvb, want, samples):
    """`steps` train steps on one fixed batch: finite losses, the last below
    the first, non-zero ViT qkv gradients in every block, and exactly the
    launches `want` in every step; then the step's times and one profiled
    step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, enqueue_ms, per_step = [], [], [], []
    fa.reset_launch_counts()
    fvb.reset_launch_counts()
    for _ in range(steps):
        before = _counts(fa, fvb)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        state, m = step(state, batch)
        end.record()
        enqueue_ms.append((time.time() - t0) * 1e3)  # host time to enqueue the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        per_step.append({k: v - before[k] for k, v in _counts(fa, fvb).items()})
    launches = _counts(fa, fvb)
    peak = torch.cuda.max_memory_allocated()
    qkv_grad_max = [b["attn"]["qkv"]["kernel"].grad.abs().max().item()
                    for b in state.params["visual_encoder"]["blocks"]]
    log(f"{label}: losses", json.dumps(losses))
    log(f"{label}: launches per step", json.dumps(per_step[-1]), "in all", json.dumps(launches))
    log(f"{label}: ViT qkv kernel grad max |g| per block", json.dumps(qkv_grad_max))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: losses not finite and falling: {losses}")
    if any(s != want for s in per_step):
        raise SystemExit(f"{label}: launches per step {per_step}, want {want} each")
    if not all(g > 0 for g in qkv_grad_max):
        raise SystemExit(f"{label}: a ViT qkv gradient is zero: {qkv_grad_max}")
    steady = statistics.median(step_ms[1:])
    prof = profile_run(lambda: step(state, batch))
    prof["device_busy_share"] = prof["device_ms"] / steady
    return dict(profile=prof, losses=losses, step_ms=step_ms, enqueue_ms=enqueue_ms,
                steady_step_ms=steady, steady_enqueue_ms=statistics.median(enqueue_ms[1:]),
                samples_per_s=samples / (steady / 1e3), peak_memory_gib=peak / 2**30,
                launches=launches, launches_per_step=per_step[-1], steps=steps, lr=1e-4)


def _med_cfg(vit_cfg):
    import os

    from vidil_tpu_torch.config import MedConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    return MedConfig.from_json(os.path.join(repo, "configs", "med_config.json"),
                               encoder_width=vit_cfg.hidden_size)


def run_caption_training(fa, fvb, device, schedule, steps):
    """Phase 9: the caption train step at full width. `schedule` "fused" is
    the trainers' default on the card (training_cfgs: K4 forward, K5
    backward per block); "classic" sets VIDIL_TPU_TRAIN_FUSED_BLOCK=0
    (blocks one by one, the attention through K1 with lse rows and K2)."""
    import os

    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 224, remat=False)  # the yamls' vit_grad_ckpt: False
    med_cfg = _med_cfg(vit_cfg)
    params = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                                device, salt=1.0))
    state = create_caption_train_state(params, 1e-4, 0.05, device=device)
    del params
    batch, prompt_length = make_train_batch(device)
    env = os.environ.pop("VIDIL_TPU_TRAIN_FUSED_BLOCK", None)
    if schedule == "classic":
        os.environ["VIDIL_TPU_TRAIN_FUSED_BLOCK"] = "0"
    try:  # training_cfgs reads the variable when the step is made
        step = make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=torch.bfloat16)
    finally:
        os.environ.pop("VIDIL_TPU_TRAIN_FUSED_BLOCK", None)
        if env is not None:
            os.environ["VIDIL_TPU_TRAIN_FUSED_BLOCK"] = env
    n = vit_cfg.num_layers
    fused = schedule == "fused"
    # the classic step's attention at 224 px (48, 12, 197, 64) fails the
    # reference's gate: plain attention, no K1 or K2, as in the reference
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0, "flash_attention_bwd": 0,
            "fused_vit_block_fwd": n if fused else 0, "fused_vit_block_bwd": n if fused else 0,
            "fused_vit_block_attention": 0, "fused_vit_block_attention_bwd": 0}
    out = train_loop(f"training ({schedule})", step, state, batch, steps, fa, fvb, want,
                     TRAIN_VIDEOS)
    out.update(schedule=schedule, videos=TRAIN_VIDEOS, frames=TRAIN_FRAMES, tokens=TRAIN_TOKENS,
               frames_per_s=out["samples_per_s"] * TRAIN_FRAMES)
    return out


def profile_run(fn):
    """One more call of `fn` (a train step after the counted ones, or a
    chunk) under torch.profiler: the CUDA kernels' device time, summed (one
    stream, so it is the busy time), the kernel launches, the top kernels by
    device time and the shares of the flash kernels (K1, K2) and of the
    kernels in csrc/fused_vit_block.cuh's namespace (K4 and K5, or K3 when
    they do not run). The profiled call's wall time is inflated by the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
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
            "fused_block_kernels_ms": sum(ms for k, ms, _ in rows
                                          if any(m in k for m in FUSED_BLOCK_KERNELS)),
            "kernel_launches": sum(n for _, _, n in rows),
            "top": [[k[:70], ms, n] for k, ms, n in rows[:8]]}


# the device kernels that K4 and K5 launch (csrc/fused_vit_block*.cu)
FUSED_BLOCK_KERNELS = ("vit_block::", "colsum_partial", "colsum_final", "sum_splits",
                       "ln_bwd_rows", "attn_bwd_dq", "attn_bwd_dkdv")

# the launches of one K4, K5 or K3 call by part (substrings of the kernel
# names torch.profiler reports): the GEMMs (csrc/gemm_sm90.cuh, or the fp32
# FMA tiles), the attention passes, the LayerNorm rows, the column sums and
# the split-K sums
KERNEL_PARTS = {"gemm": ("gemm_bf16", "gemm_f32"),
                "attention": ("attn_fwd_wgmma", "attn_fwd_f32", "attn_bwd_"),
                "ln_rows": ("ln_rows", "ln_bwd_rows"),
                "column_sums": ("colsum_partial", "colsum_final"), "sum_splits": ("sum_splits",)}


def kernel_parts(kernels):
    """A call's device ms and launches by part (KERNEL_PARTS)."""
    parts = {}
    for name, (ms, n) in kernels.items():
        part = next((p for p, keys in KERNEL_PARTS.items() if any(k in name for k in keys)),
                    "other")
        got = parts.setdefault(part, {"ms": 0.0, "launches": 0.0})
        got["ms"] += ms
        got["launches"] += n
    return parts


# ---------------------------------------------------------------------------
# the fused ViT block: K4 (forward) and K5 (backward)
# ---------------------------------------------------------------------------

# K4 vs its twin, max abs error over max |twin|: the fp32 sums run in another
# order and erff/expf differ from torch's by an ulp or two, which can flip a
# bf16 rounding of an intermediate (qkv, p, a head's output, fc1, GELU) by
# one ulp; the flipped values reach the output through the next product
BLOCK_FWD_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
# K5 vs its twin, per gradient, max abs error over that gradient's max
# |twin|: as for K4, plus the roundings of dhh, dy, do, dsb and dqkv that
# feed the weight-gradient sums over all rows
BLOCK_BWD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BLOCK_GRADS = ("dx", "dln1s", "dln1b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2s", "dln2b",
               "dw1", "db1", "dw2", "db2")
# (frames, padded tokens, true tokens): the 224-px trainers' ViT-B/16 and
# the 384-px CapFilt encode's
BLOCK_SHAPES = {"train_224": (48, 256, 197), "capfilt_384": (32, 640, 577)}
BLOCK_D, BLOCK_H, BLOCK_EPS = 768, 12, 1e-6


def block_args(B, Lp, dtype, gen, device, D=BLOCK_D):
    """x and one block's 12 parameters, as fused_vit_block passes them:
    the linears in `dtype`, the LayerNorm parameters fp32."""
    Dm = 4 * D

    def t(shape, scale, shift=0.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(dt)

    return (t((B, Lp, D), 1.0),
            t((D,), 0.1, 1.0, torch.float32), t((D,), 0.05, 0.0, torch.float32),
            t((D, 3 * D), D ** -0.5), t((3 * D,), 0.02),
            t((D, D), D ** -0.5), t((D,), 0.02),
            t((D,), 0.1, 1.0, torch.float32), t((D,), 0.05, 0.0, torch.float32),
            t((D, Dm), D ** -0.5), t((Dm,), 0.02),
            t((Dm, D), Dm ** -0.5), t((D,), 0.02))


def library_block(args, true_len):
    """The same block through PyTorch's library calls (F.layer_norm,
    F.linear, scaled_dot_product_attention, F.gelu): a yardstick only."""
    x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2, b2 = args
    B, Lp, D = x.shape
    H = BLOCK_H
    mask = None
    if true_len != Lp:
        mask = (torch.arange(Lp, device=x.device) < true_len)[None, None, None, :]
    h = F.layer_norm(x, (D,), ln1s.to(x.dtype), ln1b.to(x.dtype), BLOCK_EPS)
    q, k, v = (t.reshape(B, Lp, H, D // H).transpose(1, 2)
               for t in F.linear(h, wqkv.t(), bqkv).split(D, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask).transpose(1, 2).reshape(B, Lp, D)
    y = x + F.linear(o, wproj.t(), bproj)
    h = F.layer_norm(y, (D,), ln2s.to(x.dtype), ln2b.to(x.dtype), BLOCK_EPS)
    return y + F.linear(F.gelu(F.linear(h, w1.t(), b1)), w2.t(), b2)


def block_bound_ms(B, Lp, dtype, backward=False, D=BLOCK_D):
    """Least time for one block call, from the TPU kernels' own cost
    estimates (vidil_tpu/ops/fused_vit_block.py:173-178, :401-407): the
    forward's 2*B*Lp*D*(4D + 2Dm + 2Lp) operations (the backward three
    times that: the recompute and two products per forward product) at the
    dtype's peak rate, or its bytes over HBM: x and out (the backward: x, g
    and dx) and the weights read once (the backward also writes their fp32
    gradients)."""
    Dm = 4 * D
    itemsize = torch.empty((), dtype=dtype).element_size()
    weights = 4 * D * D + 2 * D * Dm
    flops = 2 * B * Lp * D * (4 * D + 2 * Dm + 2 * Lp) * (3 if backward else 1)
    nbytes = (3 * B * Lp * D * itemsize + weights * (itemsize + 4) if backward
              else (2 * B * Lp * D + weights) * itemsize)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel_err(a, b):
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def block_gemm_flops(B, Lp, backward=False, D=BLOCK_D):
    """Operations of one block call's GEMMs: the forward's qkv, proj, fc1 and
    fc2 products, 2*M*D*(3D + D + 2Dm); the backward's recompute (all but
    fc2) and its four data- and four weight-gradient products."""
    M, Dm = B * Lp, 4 * D
    fwd = 2 * M * D * (4 * D + 2 * Dm)
    return (2 * M * D * (4 * D + Dm) + 2 * fwd) if backward else fwd


def block_device_times(kernel, library, B, Lp, dtype, backward=False):
    """Phase 8's device times (torch.profiler, `device_profile`'s 5 calls): the
    kernel's and the library block's ms per call, the kernel's launches by
    part, and its GEMMs' rate."""
    dev_ms, kernels = device_profile(kernel)
    lib_ms, _ = device_profile(library)
    parts = kernel_parts(kernels)
    gemm_ms = parts.get("gemm", {}).get("ms", 0.0)
    return {"device_ms": dev_ms, "library_device_ms": lib_ms, "parts": parts,
            "gemm_tflops": block_gemm_flops(B, Lp, backward) / (gemm_ms * 1e-3) / 1e12
            if gemm_ms else None}


def check_fused_block(fvb, device):
    """Phase 8: K4 against fused_block_ref and K5 against
    fused_block_bwd_ref (dx and the 12 gradients) at both block shapes,
    bf16 and fp32, K4 and K5 twice on the same inputs (bitwise equal), with
    the CUDA-event times of the kernel, the twin and the library block."""
    fwd_rows, bwd_rows = [], []
    gen = torch.Generator(device=device).manual_seed(5)
    H, eps = BLOCK_H, BLOCK_EPS
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for label, (B, Lp, true_len) in BLOCK_SHAPES.items():
            args = block_args(B, Lp, dtype, gen, device)
            got = fvb._launch_fwd(args, true_len, H, eps)
            bitwise = torch.equal(got, fvb._launch_fwd(args, true_len, H, eps))
            torch.cuda.synchronize()
            want = fvb.fused_block_ref(*args, true_len=true_len, num_heads=H, eps=eps)
            rel = _rel_err(got, want)
            bound, bound_by = block_bound_ms(B, Lp, dtype)
            row = dict(shape=label, dtype=dname, x=[B, Lp, BLOCK_D], true_len=true_len,
                       max_abs_err=(got.float() - want.float()).abs().max().item(),
                       rel_err=rel, rtol=BLOCK_FWD_RTOL[dtype], run_to_run_bitwise=bitwise,
                       ms=time_ms(lambda: fvb._launch_fwd(args, true_len, H, eps)),
                       plain_ms=time_ms(lambda: fvb.fused_block_ref(
                           *args, true_len=true_len, num_heads=H, eps=eps)),
                       library_ms=time_ms(lambda: library_block(args, true_len)),
                       bound_ms=bound, bound_by=bound_by)
            row.update(block_device_times(lambda: fvb._launch_fwd(args, true_len, H, eps),
                                          lambda: library_block(args, true_len), B, Lp, dtype))
            log("kernel check (fused block fwd):", json.dumps(row))
            fwd_rows.append(row)
            if not (bool(torch.isfinite(got).all()) and bitwise and rel <= BLOCK_FWD_RTOL[dtype]):
                raise SystemExit(f"fused_vit_block_fwd disagrees with its twin: {row}")
            g = torch.randn((B, Lp, BLOCK_D), generator=gen, device=device).to(dtype)
            g[:, true_len:] = 0  # the sliced-off pad rows get no gradient
            got = fvb._launch_bwd(args, g, true_len, H, eps)
            again = fvb._launch_bwd(args, g, true_len, H, eps)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            want = fvb.fused_block_bwd_ref(*args, g, true_len=true_len, num_heads=H, eps=eps)
            errs = {n: _rel_err(a, b) for n, a, b in zip(BLOCK_GRADS, got, want)}
            leaves = [a.detach().clone().requires_grad_(True) for a in args]
            bound, bound_by = block_bound_ms(B, Lp, dtype, backward=True)
            row = dict(shape=label, dtype=dname, x=[B, Lp, BLOCK_D], true_len=true_len,
                       max_abs_err=max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got, want)),
                       rel_err=max(errs.values()), rel_errs=errs, rtol=BLOCK_BWD_RTOL[dtype],
                       run_to_run_bitwise=bitwise,
                       workspace_bytes=fvb._kernel_fns()["bwd_ws"](
                           fvb._DTYPE_CODE[dtype], B, Lp, BLOCK_D, 4 * BLOCK_D, H),
                       ms=time_ms(lambda: fvb._launch_bwd(args, g, true_len, H, eps)),
                       plain_ms=time_ms(lambda: fvb.fused_block_bwd_ref(
                           *args, g, true_len=true_len, num_heads=H, eps=eps)),
                       library_ms=time_ms(lambda: torch.autograd.grad(
                           library_block(leaves, true_len), leaves, g)),
                       bound_ms=bound, bound_by=bound_by)
            row.update(block_device_times(
                lambda: fvb._launch_bwd(args, g, true_len, H, eps),
                lambda: torch.autograd.grad(library_block(leaves, true_len), leaves, g),
                B, Lp, dtype, backward=True))
            log("kernel check (fused block bwd):", json.dumps(row))
            bwd_rows.append(row)
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            if not (finite and bitwise and max(errs.values()) <= BLOCK_BWD_RTOL[dtype]):
                raise SystemExit(f"fused_vit_block_bwd disagrees with its twin: {row}")
    return fwd_rows, bwd_rows


# the block's attention alone vs its twin (tests/test_torch_cuda_kernels.py
# states the derivation): out within 2**-6 max |v| in bf16 (flips of p's
# rounding), 1e-5 max |v| in fp32; row max 1e-4 absolute, row sum 2e-4
# relative (the fp32 sums' order)
ATTN_OUT_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
ATTN_MAX_ATOL, ATTN_SUM_RTOL = 1e-4, 2e-4


def attention_block_bound_ms(B, Lp, dtype, with_stats, D=BLOCK_D):
    """Least time for the block's attention launch: the (B, Lp, 3D) QKV
    workspace read once and the (B, Lp, D) output (and the fp32 statistics)
    written once, or its 4*B*Lp*Lp*D operations at the dtype's peak rate."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * B * Lp * D * itemsize + with_stats * 2 * B * BLOCK_H * Lp * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 4 * B * Lp * Lp * D / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_block_attention(fvb, device):
    """Phase 8: the fused block's attention launch alone (K4's; with its
    statistics, K5's recompute) against block_attention_ref at both block
    shapes, bf16 and fp32, run to run bitwise, with the times of the
    kernel, the twin and SDPA with the key mask (a yardstick only)."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(10)
    H, D = BLOCK_H, BLOCK_D
    for dtype in (torch.bfloat16, torch.float32):
        for label, (B, Lp, true_len) in BLOCK_SHAPES.items():
            qkv = torch.randn((B, Lp, 3 * D), generator=gen, device=device).to(dtype)
            q, k, v = (t.reshape(B, Lp, H, D // H).transpose(1, 2) for t in qkv.split(D, dim=-1))
            mask = None
            if true_len != Lp:
                mask = (torch.arange(Lp, device=device) < true_len)[None, None, None, :]
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            v_max = v.float().abs().max().item()
            for with_stats in (False, True):
                kernel = lambda: fvb._launch_attention(qkv, true_len, H, with_stats=with_stats)
                got, again = kernel(), kernel()
                torch.cuda.synchronize()
                want = fvb.block_attention_ref(qkv, true_len=true_len, num_heads=H,
                                               with_stats=with_stats)
                got, again, want = ((t,) if not with_stats else t for t in (got, again, want))
                bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
                err = (got[0].float() - want[0].float()).abs().max().item()
                ok = (bitwise and bool(torch.isfinite(got[0]).all())
                      and err <= ATTN_OUT_TOL[dtype] * v_max)
                row = dict(shape=label, dtype=str(dtype).replace("torch.", ""), stats=with_stats,
                           qkv=[B, Lp, 3 * D], true_len=true_len, max_abs_err=err,
                           limit=ATTN_OUT_TOL[dtype] * v_max, run_to_run_bitwise=bitwise)
                if with_stats:
                    row.update(row_max_err=(got[1] - want[1]).abs().max().item(),
                               row_sum_rel_err=((got[2] - want[2]).abs() / want[2]).max().item())
                    ok = ok and (row["row_max_err"] <= ATTN_MAX_ATOL
                                 and row["row_sum_rel_err"] <= ATTN_SUM_RTOL)
                bound, bound_by = attention_block_bound_ms(B, Lp, dtype, with_stats)
                row.update(ms=time_ms(kernel), plain_ms=time_ms(lambda: fvb.block_attention_ref(
                               qkv, true_len=true_len, num_heads=H, with_stats=with_stats)),
                           library_ms=time_ms(library), bound_ms=bound, bound_by=bound_by,
                           device_ms=device_profile(kernel)[0],
                           library_device_ms=device_profile(library)[0])
                log("kernel check (fused block attention):", json.dumps(row))
                rows.append(row)
                if not ok:
                    raise SystemExit(f"fused_vit_block_attention disagrees with its twin: {row}")
    return rows


# K5's attention backward alone vs block_attention_bwd_ref, per part (dq,
# dk, dv; D; dbqkv), max abs error over that part's max |twin|. bf16: both
# round at the same points (p for p^T do, dsb, the output); the fp32 sums
# (s, dp: 64 terms; D, dq, dk, dv: up to 640) run in another order, which
# can flip the output's one rounding (2**-8 of an element) and, rarely, a
# rounding of p or dsb (2**-8 of one product term): 2**-7 of the part's
# max. fp32 (and D, formed in fp32 from fp32 p and dp in both dtypes): the
# order alone, 1e-5. dbqkv sums the unrounded values over every row: the
# bar of the values it sums
ATTN_BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
ATTN_BWD_DELTA_TOL = 1e-5


def block_attention_bwd_bound_ms(B, Lp, true_len, dtype, D=BLOCK_D):
    """Least time for K5's attention backward alone: qkv and do read once,
    dqkv written once, the row max and sum read and D written (fp32), or
    the five products it needs (s, dp, dv, dq, dk: 2 Lp true_len 64 each
    per frame and head; the pad rows are real rows, the keys past true_len
    contribute nothing) at the dtype's peak rate."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 7 * B * Lp * D * itemsize + 3 * B * BLOCK_H * Lp * 4 + 3 * D * 4
    flops = 10 * B * Lp * true_len * D
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_block_attention_bwd(fvb, device):
    """Phase 8: K5's attention backward alone (its dq and dk/dv passes with
    dbqkv) on K4's attention statistics, against block_attention_bwd_ref at
    both block shapes, bf16 and fp32, run to run bitwise; the times of the
    kernel, the twin and SDPA's backward with the key mask (a yardstick
    only), device ms by torch.profiler, and TFLOP/s over the five products
    it needs and the nine it runs (the dq pass walks its key tiles twice;
    keys padded to 128)."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(11)
    H, D = BLOCK_H, BLOCK_D
    for dtype in (torch.bfloat16, torch.float32):
        for label, (B, Lp, true_len) in BLOCK_SHAPES.items():
            qkv = torch.randn((B, Lp, 3 * D), generator=gen, device=device).to(dtype)
            do = (torch.randn((B, Lp, D), generator=gen, device=device) * 0.1).to(dtype)
            _, row_max, row_sum = fvb._launch_attention(qkv, true_len, H, with_stats=True)
            kernel = lambda: fvb._launch_attention_bwd(qkv, do, row_max, row_sum, true_len, H)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            want = fvb.block_attention_bwd_ref(qkv, do, row_max, row_sum, true_len=true_len,
                                               num_heads=H)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = {name: _rel_err(got[0][..., i * D:(i + 1) * D], want[0][..., i * D:(i + 1) * D])
                    for i, name in enumerate(("dq", "dk", "dv"))}
            errs.update(delta=_rel_err(got[1], want[1]), dbqkv=_rel_err(got[2], want[2]))
            tol = ATTN_BWD_TOL[dtype]
            ok = (bitwise and bool(torch.isfinite(got[0]).all())
                  and all(errs[k] <= tol for k in ("dq", "dk", "dv", "dbqkv"))
                  and errs["delta"] <= ATTN_BWD_DELTA_TOL)
            q, k, v = (t.reshape(B, Lp, H, D // H).transpose(1, 2).detach().requires_grad_(True)
                       for t in qkv.split(D, dim=-1))
            mask = (torch.arange(Lp, device=device) < true_len)[None, None, None, :]
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            g = do.reshape(B, Lp, H, D // H).transpose(1, 2)
            library = lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
            bound, bound_by = block_attention_bwd_bound_ms(B, Lp, true_len, dtype)
            dev_ms, kernels = device_profile(kernel)
            k_pad = -(-true_len // 128) * 128
            row = dict(shape=label, dtype=str(dtype).replace("torch.", ""),
                       qkv=[B, Lp, 3 * D], true_len=true_len, rel_errs=errs,
                       max_abs_err=(got[0].float() - want[0].to(dtype).float()).abs().max().item(),
                       rtol=tol, delta_rtol=ATTN_BWD_DELTA_TOL, run_to_run_bitwise=bitwise,
                       ms=time_ms(kernel), plain_ms=time_ms(lambda: fvb.block_attention_bwd_ref(
                           qkv, do, row_max, row_sum, true_len=true_len, num_heads=H)),
                       library_ms=time_ms(library), bound_ms=bound, bound_by=bound_by,
                       device_ms=dev_ms, library_device_ms=device_profile(library)[0],
                       kernels={name[:60]: v for name, v in kernels.items()},
                       tflops_5_products=10 * B * Lp * true_len * D / (dev_ms * 1e-3) / 1e12,
                       tflops_9_products=18 * B * Lp * k_pad * D / (dev_ms * 1e-3) / 1e12)
            log("kernel check (fused block attention bwd):", json.dumps(row))
            rows.append(row)
            if not ok:
                raise SystemExit(f"fused_vit_block_attention_bwd disagrees with its twin: {row}")
    return rows


# ---------------------------------------------------------------------------
# the VQA fine-tune
# ---------------------------------------------------------------------------

# train_blip_video_vqa_msrvtt.yaml's shapes at its reference batch
VQA_QUESTIONS, VQA_FRAMES, VQA_Q_TOKENS, VQA_A_TOKENS, VQA_STEPS = 8, 4, 35, 12, 8
VQA_ANSWER_LIST, VQA_K = 256, 128


def make_vqa_batch(tok, device):
    """One fixed batch: 8 questions x 4 frames at 224 px (normalized noise),
    [ENC] questions of 8-35 tokens padded to 35, 1-3 answers per question
    ([DEC] + words + [SEP], 3-12 tokens padded to 12) with weight 0.2."""
    rng = np.random.default_rng(1)

    def rows(n_rows, width, first, lo):
        ids = np.zeros((n_rows, width), np.int64)
        mask = np.zeros_like(ids)
        for b in range(n_rows):
            n = int(rng.integers(lo, width + 1))
            ids[b, :n] = [first] + list(rng.integers(1000, 30000, n - 2)) + [tok.sep_token_id]
            mask[b, :n] = 1
        return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)

    q_ids, q_mask = rows(VQA_QUESTIONS, VQA_Q_TOKENS, tok.enc_token_id, 8)
    per_question = rng.integers(1, 4, VQA_QUESTIONS)
    a_ids, a_mask = rows(int(per_question.sum()), VQA_A_TOKENS, tok.bos_token_id, 3)
    gen = torch.Generator(device=device).manual_seed(6)
    video = torch.randn((VQA_QUESTIONS, VQA_FRAMES, 224, 224, 3), generator=gen, device=device)
    index = torch.from_numpy(np.repeat(np.arange(VQA_QUESTIONS), per_question)).to(device)
    return {"video": video, "question_ids": q_ids, "question_mask": q_mask,
            "answer_ids": a_ids, "answer_mask": a_mask, "answer_question_index": index,
            "weights": torch.full((a_ids.shape[0],), 0.2, device=device)}


def run_vqa(fa, fvb, device):
    """Phase 10: make_vqa_train_step at full width (ViT-B/16 224 px with the
    yaml's vit_grad_ckpt, MED-base encoder and decoder), synthetic weights,
    bf16, the default schedule (K4 + K5); then vqa_generate_ids (3 beams,
    10 tokens, beam_group_kv) and rank_answer (k = 128 over 256 synthetic
    answers) on the batch's questions."""
    import os

    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.models.blip_vqa import blip_vqa_shapes, rank_answer, vqa_generate_ids
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab
    from vidil_tpu_torch.train.vqa import create_vqa_train_state, make_vqa_train_step
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 224, remat=True)  # the yaml's vit_grad_ckpt: true
    med_cfg = _med_cfg(vit_cfg)
    params = convert.from_jax_params(synth_tree(blip_vqa_shapes(vit_cfg, med_cfg), device,
                                                salt=3.0))
    state = create_vqa_train_state(params, 1e-4, 0.05, device=device)
    del params
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        tok = BlipTokenizer(vocab)
    batch = make_vqa_batch(tok, device)
    step = make_vqa_train_step(vit_cfg, med_cfg, dtype=torch.bfloat16)
    n = vit_cfg.num_layers
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0, "flash_attention_bwd": 0,
            "fused_vit_block_fwd": n, "fused_vit_block_bwd": n, "fused_vit_block_attention": 0,
            "fused_vit_block_attention_bwd": 0}
    out = train_loop("vqa training", step, state, batch, VQA_STEPS, fa, fvb, want, VQA_QUESTIONS)
    out.update(questions=VQA_QUESTIONS, frames=VQA_FRAMES, answers=int(batch["weights"].shape[0]),
               question_tokens=VQA_Q_TOKENS, answer_tokens=VQA_A_TOKENS)

    rng = np.random.default_rng(2)
    a_ids = np.zeros((VQA_ANSWER_LIST, 6), np.int64)
    a_mask = np.zeros_like(a_ids)
    for i in range(VQA_ANSWER_LIST):
        n_words = int(rng.integers(1, 5))
        a_ids[i, :n_words + 2] = [tok.bos_token_id, *rng.integers(1000, 30000, n_words),
                                  tok.sep_token_id]
        a_mask[i, :n_words + 2] = 1
    a_ids, a_mask = torch.from_numpy(a_ids).to(device), torch.from_numpy(a_mask).to(device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        embeds = blip.encode_video_frames(state.params, batch["video"], vit_cfg,
                                          dtype=torch.bfloat16)
        seqs = vqa_generate_ids(state.params, embeds, batch["question_ids"],
                                batch["question_mask"], med_cfg, tok, max_length=10,
                                num_beams=3, dtype=torch.bfloat16, beam_group_kv=True)
        torch.cuda.synchronize()
        t1 = time.time()
        ranked = rank_answer(state.params, embeds, batch["question_ids"], batch["question_mask"],
                             a_ids, a_mask, k=VQA_K, med_cfg=med_cfg, tokenizer=tok,
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t2 = time.time()
    seqs, ranked = seqs.cpu(), ranked.cpu()
    answers = tok.batch_decode(seqs.numpy())
    log("vqa: generated ids", json.dumps(seqs[:3].tolist()), "answers", json.dumps(answers[:3]),
        "ranked", json.dumps(ranked.tolist()))
    if not (tuple(seqs.shape) == (VQA_QUESTIONS, 10) and all(_well_formed(r, tok) for r in seqs)
            and bool(((seqs >= 0) & (seqs < med_cfg.vocab_size)).all())
            and all(isinstance(a, str) for a in answers)):
        raise SystemExit(f"vqa: malformed generated answers {seqs.tolist()}")
    if not (tuple(ranked.shape) == (VQA_QUESTIONS,)
            and bool(((ranked >= 0) & (ranked < VQA_ANSWER_LIST)).all())):
        raise SystemExit(f"vqa: malformed ranked answers {ranked.tolist()}")
    out.update(generate_s=t1 - t0, rank_s=t2 - t1, rank_k=VQA_K, answer_list=VQA_ANSWER_LIST)
    return out


def _well_formed(row, tok) -> bool:
    """[DEC] first, then tokens up to an optional [SEP], then only [PAD]."""
    row = row.tolist()
    if row[0] != tok.bos_token_id:
        return False
    end = row.index(tok.sep_token_id) if tok.sep_token_id in row else len(row)
    return all(t == tok.pad_token_id for t in row[end + 1:])


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def in_situ_fused_block(fvb, device, blk=None, frames=None):
    """Phases 11 and 15: one full-width ViT block at the trainers' shape
    (or `blk` over `frames` frames) through fused_vit_block (K4 forward, K5
    backward), bf16 compute over fp32 parameters, and through the twins:
    the input gradient and the qkv weight gradient (reported)."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    cfg = ViTConfig.from_name("base", 224)
    if blk is None:
        blk = convert.from_jax_params(synth_tree({"blocks": blip.vit_shapes(cfg)["blocks"]},
                                                 device, salt=1.0))["blocks"][0]
    blk = _detached(blk)
    gen = torch.Generator(device=device).manual_seed(7)
    B, Lp, true_len = BLOCK_SHAPES["train_224"]
    B = frames or B
    x0 = torch.zeros((B, Lp, cfg.hidden_size), device=device)
    x0[:, :true_len] = torch.randn((B, true_len, cfg.hidden_size), generator=gen, device=device)
    r = torch.randn((B, true_len, cfg.hidden_size), generator=gen, device=device)

    def grads():
        x = x0.to(torch.bfloat16).requires_grad_(True)
        w = blk["attn"]["qkv"]["kernel"].clone().requires_grad_(True)
        p = dict(blk, attn=dict(blk["attn"], qkv=dict(blk["attn"]["qkv"], kernel=w)))
        out = fvb.fused_vit_block(p, x, cfg.num_heads, cfg.layer_norm_eps, true_len,
                                  pallas_bwd=True)
        return torch.autograd.grad((out[:, :true_len].float() * r).sum(), (x, w))

    before = dict(fvb.launch_counts)
    got = grads()
    if {k: fvb.launch_counts[k] - before[k] for k in before} != {
            "fused_vit_block_fwd": 1, "fused_vit_block_bwd": 1, "fused_vit_block_attention": 0,
            "fused_vit_block_attention_bwd": 0}:
        raise SystemExit("in-situ fused block: the kernels did not run")
    launch_fwd, launch_bwd = fvb._launch_fwd, fvb._launch_bwd
    fvb._launch_fwd = lambda args, tl, nh, eps: fvb.fused_block_ref(
        *args, true_len=tl, num_heads=nh, eps=eps)
    fvb._launch_bwd = lambda args, g, tl, nh, eps: fvb.fused_block_bwd_ref(
        *args, g.to(args[0].dtype), true_len=tl, num_heads=nh, eps=eps)
    try:
        want = grads()
    finally:
        fvb._launch_fwd, fvb._launch_bwd = launch_fwd, launch_bwd
    out = {}
    for name, a, b in zip(("dx", "d_qkv_kernel"), got, want):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"in-situ fused block: non-finite {name}")
        out[f"{name}_max_abs_diff"] = (a.float() - b.float()).abs().max().item()
        out[f"{name}_max_abs"] = b.float().abs().max().item()
    return out


def in_situ_fused_encode(engine, frames, vit_cfg, switch, counts, kernel):
    """Phases 6 and 13 (reported): the 384-px captioner encode of one CapFilt
    chunk with one ViT switch on (`use_fused_block`: K4 per block;
    `use_fused_mlp`: K3 per block, 32 frames x 577 tokens) against the
    classic encode, after one block and after twelve. `kernel` must launch
    once per block (`counts` is its module's launch_counts)."""
    import dataclasses

    from vidil_tpu_torch.models import vit
    from vidil_tpu_torch.ops.image import preprocess_any

    x = preprocess_any(engine._put(frames), vit_cfg.image_size)
    ve = engine.captioner_params["visual_encoder"]
    fused_cfg = dataclasses.replace(vit_cfg, **{switch: True})
    out = {"frames": int(x.shape[0])}
    with torch.no_grad():
        for label, params in (("one_block", dict(ve, blocks=ve["blocks"][:1])), ("twelve", ve)):
            before = counts[kernel]
            a = vit.vit_forward(params, x, fused_cfg, dtype=torch.bfloat16)
            launched = counts[kernel] - before
            b = vit.vit_forward(params, x, vit_cfg, dtype=torch.bfloat16)
            if launched != len(params["blocks"]) or not torch.isfinite(a).all():
                raise SystemExit(f"in-situ {switch} encode: {launched} {kernel} launches "
                                 "or non-finite")
            out[f"bf16_{label}_max_abs_diff"] = (a.float() - b.float()).abs().max().item()
            out[f"bf16_{label}_max_abs"] = b.float().abs().max().item()
    return out


# phase 11's classic block: ViT-B/384 over a CapFilt chunk's 32 frames x 577
# tokens, where the reference's gate sends the attention to the kernels
SITU_FRAMES = N_VIDEOS * N_FRAMES


def in_situ_backward(fa, device):
    """Phase 11: one full-width ViT-B/384 block on the classic schedule,
    bf16, over 32 frames of 577 tokens (the attention passes the
    reference's gate): exactly one K1-with-lse and one K2 launch, then the
    input gradient and the qkv weight gradient through the kernels and
    through the twins (at the kernels' tiling). Returns the report and the
    kernels' launches."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert, vit
    from vidil_tpu_torch.utils.synth import synth_tree

    cfg = ViTConfig.from_name("base", 384)
    blk = convert.from_jax_params(synth_tree({"blocks": blip.vit_shapes(cfg)["blocks"]},
                                             device, salt=1.0))["blocks"][0]
    gen = torch.Generator(device=device).manual_seed(4)
    shape = (SITU_FRAMES, cfg.seq_len, cfg.hidden_size)
    x0 = torch.randn(shape, generator=gen, device=device)
    r = torch.randn(shape, generator=gen, device=device)

    def grads():
        x = x0.clone().requires_grad_(True)
        w = blk["attn"]["qkv"]["kernel"].clone().requires_grad_(True)
        p = dict(blk, attn=dict(blk["attn"], qkv=dict(blk["attn"]["qkv"], kernel=w)))
        out = vit.block_forward(p, x, cfg.num_heads, cfg.layer_norm_eps, dtype=torch.bfloat16)
        return torch.autograd.grad((out.float() * r).sum(), (x, w))

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 1, "flash_attention_bwd": 1}
    if launches != want:
        raise SystemExit(f"in-situ backward at {shape}: launches {launches}, want {want}")
    fwd, bwd = fa._forward, fa._backward
    fa._forward = lambda q, k, v, with_lse: fa.flash_attention_ref(
        q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype], return_lse=with_lse)
    fa._backward = lambda q, k, v, o, lse, g: fa.flash_attention_bwd_ref(
        q, k, v, o, lse, g.to(q.dtype))
    try:
        want = grads()
    finally:
        fa._forward, fa._backward = fwd, bwd
    out = {"x": list(shape), "launches": launches}
    for name, a, b in zip(("dx", "d_qkv_kernel"), got, want):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"in-situ backward: non-finite {name}")
        out[f"{name}_max_abs_diff"] = (a - b).abs().max().item()
        out[f"{name}_max_abs"] = b.abs().max().item()
    return out, launches


# ---------------------------------------------------------------------------
# visual tokenization: the fused MLP (K3) and the two engines
# ---------------------------------------------------------------------------

# K3 vs its plain version, on the same rounding points. bf16: the sums run in
# another order and erff/expf differ from torch's by an ulp, which can flip
# the rounding of an activation (moving an output by |w2| times its ulp) or
# of an output: bounded by 1e-2 of max |out|. fp32: order only, 3e-5.
MLP_BAR = {torch.bfloat16: ("rel", 1e-2), torch.float32: ("abs", 3e-5)}
# (rows, D, hidden): the ViT-B/384 encode of a chunk (8 videos x 8 frames x
# 577 tokens) and an ITM rerank block (4 frames x 128 texts x 16 tokens)
MLP_SHAPES = {"vit_encode": (VT_VIDEOS * VT_FRAMES * 577, 768, 3072),
              "itm_block": (VT_ITM_ROWS * VT_K_TEST * 16, 768, 3072)}


def mlp_bound_ms(M, D, Dm, dtype):
    """Least time for one K3 call: x and out once, both weights and biases
    once over HBM, or its two products' 4*M*D*Dm operations at the dtype's
    peak rate."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * M * D + 2 * D * Dm + Dm + D) * itemsize
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 4 * M * D * Dm / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_fused_mlp(fm, device):
    """Phase 12: K3 against fused_mlp_ref at both shapes, bf16 and fp32, run
    to run bitwise, with the CUDA-event times of the kernel, the plain
    version and F.linear + F.gelu + F.linear."""
    rows = []
    gen = torch.Generator(device=device).manual_seed(8)
    for dtype in (torch.bfloat16, torch.float32):
        for label, (M, D, Dm) in MLP_SHAPES.items():
            t = lambda shape, scale: (torch.randn(shape, generator=gen, device=device)
                                      * scale).to(dtype)
            args = (t((M, D), 1.0), t((D, Dm), D ** -0.5), t((Dm,), 0.02),
                    t((Dm, D), Dm ** -0.5), t((D,), 0.02))
            got = fm._launch(*args)
            again = fm._launch(*args)
            torch.cuda.synchronize()
            want = fm.fused_mlp_ref(*args)
            err = (got.float() - want.float()).abs().max().item()
            kind, bar = MLP_BAR[dtype]
            limit = bar * want.float().abs().max().item() if kind == "rel" else bar
            bitwise = torch.equal(got, again)
            x, w1, b1, w2, b2 = args
            bound, bound_by = mlp_bound_ms(M, D, Dm, dtype)
            row = dict(shape=label, dtype=str(dtype).replace("torch.", ""), x=[M, D], hidden=Dm,
                       max_abs_err=err, limit=limit, run_to_run_bitwise=bitwise,
                       ms=time_ms(lambda: fm._launch(*args)),
                       plain_ms=time_ms(lambda: fm.fused_mlp_ref(*args)),
                       library_ms=time_ms(lambda: F.linear(F.gelu(F.linear(x, w1.t(), b1)),
                                                           w2.t(), b2)),
                       bound_ms=bound, bound_by=bound_by)
            dev_ms, kernels = device_profile(lambda: fm._launch(*args))
            lib_ms, _ = device_profile(lambda: F.linear(F.gelu(F.linear(x, w1.t(), b1)),
                                                        w2.t(), b2))
            # fc1 is the GEMM with K3's GELU epilogue (kEpiGeluF32 = 5), fc2
            # the one with the plain store (kEpiStore = 0); 2*M*D*Dm each
            gemms = {label: sum(ms for k, (ms, _) in kernels.items() if key in k)
                     for label, key in (("fc1", "BlockEpi<5>"), ("fc2", "BlockEpi<0>"))}
            row.update(device_ms=dev_ms, library_device_ms=lib_ms, gemm_ms=gemms,
                       gemm_tflops={k: 2 * M * D * Dm / (v * 1e-3) / 1e12 if v else None
                                    for k, v in gemms.items()},
                       kernels={k.split("(")[0]: v for k, v in kernels.items()})
            log("kernel check (fused mlp):", json.dumps(row))
            rows.append(row)
            if not (bool(torch.isfinite(got).all()) and bitwise and err <= limit):
                raise SystemExit(f"fused_mlp_fwd disagrees with its plain version: {row}")
    return rows


# K6 (csrc/decode_cross_attention.cu) at CapFilt's beam decode: 32 memory
# rows (8 videos x 4 frames) of 577 keys, 12 heads of 64, 3 beams a memory
# row; a step's one token, the prefill's four ([DEC] "a picture of"), and one
# row a memory row (sampling, non-grouped beams)
K6_SHAPES = {"beam_step": (3, 1), "beam_prefill": (3, 4), "sample_step": (1, 1)}
K6_B, K6_H, K6_LK, K6_DH, K6_LAYERS = N_VIDEOS * N_FRAMES, 12, 577, 64, 12
# the decode's cross-attentions a beam decode: every layer of the prefill and
# of each of the 15 steps (20 tokens, a 4-token prompt)
K6_PER_DECODE = K6_LAYERS * 16
# the share of a replayed decode's kernel records torch.profiler may lose
# (1.3-1.7 % seen on the card)
PROFILE_LOSS = 0.05


def k6_limit(want):
    """Kernel vs plain version: the fp32 sums run in another order, which
    can flip a bf16 rounding of a probability or of the output by an ulp or
    two: 4 bf16 ulps of max|want| (a dropped key moves it by 10 or more,
    tests/test_torch_decode_attention.py); fp32 only moves the last bits."""
    if want.dtype == torch.float32:
        return 2e-5
    m = max(want.float().abs().max().item(), torch.finfo(torch.bfloat16).tiny)
    return 4 * 2.0 ** (math.floor(math.log2(m)) - 7)


def decode_attention_bound_ms(B, H, rows, Lk, Dh, dtype):
    """Least time for one K6 call: q and out (rows a memory row) and k and v
    once over HBM, or its 4*B*H*rows*Lk*Dh operations at the dtype's peak."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * H * rows * Dh + 2 * B * H * Lk * Dh) * itemsize
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 4 * B * H * rows * Lk * Dh / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_decode_attention(da, device):
    """Phase 3b: K6 against decode_cross_attention_ref at CapFilt's step,
    prefill and one-row shapes, bf16 and fp32, on the decode's head-split
    views of 12 layers' memory (each call reads the next layer's, as the
    decode does, so K and V come from HBM and not from L2), run to run
    bitwise; the CUDA-event ms of the kernel, the plain version and one
    F.scaled_dot_product_attention call on the beam-replicated K/V (a
    yardstick only), the kernel's device ms by torch.profiler, its bound."""
    from vidil_tpu_torch.models.layers import merge_heads, split_heads

    rows = []
    gen = torch.Generator(device=device).manual_seed(9)
    B, H, Lk, Dh = K6_B, K6_H, K6_LK, K6_DH
    for dtype in (torch.bfloat16, torch.float32):
        bufs = torch.randn(2, K6_LAYERS, B, Lk, H * Dh, generator=gen, device=device).to(dtype)
        ks, vs = (split_heads(b, H) for b in bufs)  # (layers, B, H, Lk, Dh) views
        for label, (G, L) in K6_SHAPES.items():
            q = torch.randn(B * G, L, H * Dh, generator=gen, device=device).to(dtype)
            got = da.decode_cross_attention(q, ks[0], vs[0], G)
            again = da.decode_cross_attention(q, ks[0], vs[0], G)
            torch.cuda.synchronize()
            want = da.decode_cross_attention_ref(q, ks[0], vs[0], G)
            err = (got.float() - want.float()).abs().max().item()
            limit = k6_limit(want)
            bitwise = torch.equal(got, again)
            layer = [0]

            def rotating(fn):
                def call():
                    i = layer[0] = (layer[0] + 1) % K6_LAYERS
                    return fn(q, ks[i], vs[i], G)
                return call

            qh = split_heads(q, H)
            reps = [(k.repeat_interleave(G, 0).contiguous(), v.repeat_interleave(G, 0)
                     .contiguous()) for k, v in zip(ks, vs)]

            def library():
                i = layer[0] = (layer[0] + 1) % K6_LAYERS
                return merge_heads(F.scaled_dot_product_attention(qh, *reps[i]))

            bound, bound_by = decode_attention_bound_ms(B, H, G * L, Lk, Dh, dtype)
            dev_ms, kernels = device_profile(rotating(da.decode_cross_attention),
                                             reps=K6_LAYERS)
            row = dict(shape=label, dtype=str(dtype).replace("torch.", ""),
                       q=[B * G, L, H * Dh], kv=[B, H, Lk, Dh], group=G, max_abs_err=err,
                       limit=limit, run_to_run_bitwise=bitwise,
                       ms=time_ms(rotating(da.decode_cross_attention)),
                       plain_ms=time_ms(rotating(da.decode_cross_attention_ref)),
                       library_ms=time_ms(library), device_ms=dev_ms,
                       library_device_ms=device_profile(library, reps=K6_LAYERS)[0],
                       bound_ms=bound, bound_by=bound_by, bound_share=bound / dev_ms,
                       kernels={k.split("(")[0]: v for k, v in kernels.items()})
            del reps
            log("kernel check (decode cross-attention K6):", json.dumps(row))
            rows.append(row)
            if not (bool(torch.isfinite(got).all()) and bitwise and err <= limit):
                raise SystemExit(f"decode_cross_attention disagrees with its plain version: {row}")
        del bufs, ks, vs
    return rows


def _vt_engines(device):
    """The two engines at full width with synthetic weights made on the
    device, bf16: BLIP (ViT-B/384, MED-base from configs/med_config.json,
    use_fused_mlp in both towers, embed 256) and CLIP ViT-L/14 with a
    byte-level BPE (every id below 49,408; <|endoftext|> the highest)."""
    import os

    from vidil_tpu_torch.config import CLIPConfig, MedConfig, ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.models.clip import clip_shapes
    from vidil_tpu_torch.pipeline.visual_tokenization import (
        BlipTokenizationEngine,
        ClipTokenizationEngine,
    )
    from vidil_tpu_torch.tokenizer import (
        BlipTokenizer,
        ClipBPETokenizer,
        write_bench_vocab,
        write_test_clip_bpe,
    )
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 384, use_fused_mlp=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    med_cfg = MedConfig.from_json(os.path.join(repo, "configs", "med_config.json"),
                                  encoder_width=vit_cfg.hidden_size, use_fused_mlp=True)
    clip_cfg = CLIPConfig.vit_l_14()
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        tok = BlipTokenizer(vocab)
        bpe = [os.path.join(tmp, "vocab.json"), os.path.join(tmp, "merges.txt")]
        write_test_clip_bpe(*bpe, words=[])
        clip_tok = ClipBPETokenizer(*bpe, max_len=clip_cfg.max_text_len)
    if not clip_tok.eos_token_id == clip_tok.vocab_size - 1 < clip_cfg.vocab_size:
        raise SystemExit("synthetic CLIP BPE: <|endoftext|> must be the highest id")
    blip_engine = BlipTokenizationEngine(
        convert.from_jax_params(synth_tree(blip.blip_itm_shapes(vit_cfg, med_cfg), device,
                                           salt=2.0)),
        vit_cfg, med_cfg, tok, k_test=VT_K_TEST, dtype=torch.bfloat16, device=device)
    clip_engine = ClipTokenizationEngine(
        convert.from_jax_params(synth_tree(clip_shapes(clip_cfg), device, salt=4.0)),
        clip_cfg, clip_tok, dtype=torch.bfloat16, device=device)
    return blip_engine, clip_engine


def run_visual_tokenization(fa, fm, device):
    """Phase 13: both engines over the vendored vg ontology; per engine the
    ontology embedding (timed, then cached as the CLI caches it), a warm-up
    chunk and a timed chunk through predict_videos; launch counts of K1 and
    K3 against the counts the shapes give."""
    import os

    from vidil_tpu_torch.pipeline import visual_tokenization as vt

    repo = os.path.dirname(os.path.abspath(__file__))
    onto = vt.load_ontology(vt.ontology_paths("vg", os.path.join(repo, "visual_token_ontology")))
    counts = {k: len(v) for k, v in onto.items()}
    if counts != {"objects": 19958, "attributes": 15026, "scenes": 365, "verbs": 7410}:
        raise SystemExit(f"vendored vg ontology counts {counts}")
    fns = vt.get_prefix_prompt_functions("v1")
    blip_engine, clip_engine = _vt_engines(device)
    gen = torch.Generator(device=device).manual_seed(9)
    out = {}
    for name, engine in (("blip", blip_engine), ("clip", clip_engine)):
        blip_mode = name == "blip"
        size = engine.vit_cfg.image_size if blip_mode else engine.cfg.image_size
        n_layers = engine.med_cfg.num_layers if blip_mode else 0
        cache = {}
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        fm.reset_launch_counts()
        t0 = time.time()
        for key, terms in onto.items():
            cache[key] = engine.embed_texts([fns[key](t) for t in terms])
        torch.cuda.synchronize()
        onto_s = time.time() - t0
        # K3: 12 per 512-text block of >= 2048 rows of the MED text encode
        want_k3 = 0
        for key, terms in onto.items():
            n, L = len(terms), cache[key][1].shape[1] if blip_mode else 0
            blocks = 1 if n <= vt.EMBEDDING_BATCH_LIMIT_TEXT else math.ceil(
                n / vt.EMBEDDING_BATCH_LIMIT_TEXT)
            if min(n, vt.EMBEDDING_BATCH_LIMIT_TEXT) * L >= 2048:
                want_k3 += n_layers * blocks
        onto_launches = {"fused_mlp_fwd": fm.launch_counts["fused_mlp_fwd"],
                         "flash_attention_fwd": fa.launch_counts["flash_attention_fwd"]}
        if onto_launches != {"fused_mlp_fwd": want_k3, "flash_attention_fwd": 0}:
            raise SystemExit(f"{name} ontology embedding launches {onto_launches}, want "
                             f"{want_k3} K3 and no K1")
        rerank_s = []
        if blip_mode:
            rerank_all = engine.rerank_all

            def timed_rerank(*a, **kw):
                t = time.time()
                r = rerank_all(*a, **kw)  # ends in a copy to the host
                rerank_s.append(time.time() - t)
                return r

            engine.rerank_all = timed_rerank
        for chunk in range(2):
            frames = {f"c{chunk}v{v}": torch.randint(0, 256, (VT_FRAMES, size, size, 3),
                                                     generator=gen, device=device,
                                                     dtype=torch.uint8)
                      for v in range(VT_VIDEOS)}
            caps = {vid: [f"caption of {vid}"] for vid in frames}
            rerank_s.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            fm.reset_launch_counts()
            t0 = time.time()
            res = vt.predict_videos(engine, frames, caps, onto, fns, topk_visualize=VT_TOPK,
                                    text_cache=cache, pad_to_videos=VT_VIDEOS)
            chunk_s = time.time() - t0
        launches = {"fused_mlp_fwd": fm.launch_counts["fused_mlp_fwd"],
                    "flash_attention_fwd": fa.launch_counts["flash_attention_fwd"]}
        peak, rerank_total = torch.cuda.max_memory_allocated(), sum(rerank_s)
        prof = profile_run(lambda: vt.predict_videos(engine, frames, caps, onto, fns,
                                                     topk_visualize=VT_TOPK, text_cache=cache,
                                                     pad_to_videos=VT_VIDEOS))
        prof["k3_kernels_ms"] = prof.pop("fused_block_kernels_ms")
        prof["device_busy_share"] = prof["device_ms"] / (chunk_s * 1e3)
        n_frames = VT_VIDEOS * VT_FRAMES
        if blip_mode:
            # the ViT encode (K3 + K1 per block), then per category
            # ceil(frames / 4) ITM blocks of 4 frames x 128 texts x L tokens,
            # L the category's text length: K3 in the FFN at >= 2048 rows, and
            # K1 in the grouped cross-attention, (4, 12, 128 L, 64) over
            # (4, 12, 577, 64), where the reference's gate passes it
            n_vit = engine.vit_cfg.num_layers
            want = {"fused_mlp_fwd": n_vit, "flash_attention_fwd": n_vit}
            for key in onto:
                L = cache[key][1].shape[1]
                blocks = n_layers * math.ceil(n_frames / VT_ITM_ROWS)
                q = torch.empty((VT_ITM_ROWS, 12, VT_K_TEST * L, 64), device="meta")
                k = torch.empty((VT_ITM_ROWS, 12, 577, 64), device="meta")
                want["fused_mlp_fwd"] += blocks * (VT_ITM_ROWS * VT_K_TEST * L >= 2048)
                want["flash_attention_fwd"] += blocks * fa._flash_profitable(q, k, None)
        else:  # quick_gelu: no K3; CLIP-L's (64, 16, 257, 64) fails the gate: no K1
            want = {"fused_mlp_fwd": 0, "flash_attention_fwd": 0}
        if launches != want:
            raise SystemExit(f"{name} chunk launches {launches}, want {want}")
        for vid, obj in res.items():
            ok = len(obj["frame_tokens"]) == VT_FRAMES and all(
                len(ft[key]) == VT_TOPK and set(ft[key]) <= set(onto[key])
                for ft in obj["frame_tokens"] for key in onto)
            ok = ok and all(set(obj["aggregated_tokens"][k]) <= set(onto[k]) for k in onto)
            if not ok or set(res) != set(frames):
                raise SystemExit(f"{name}: malformed visual tokens for {vid}: {obj}")
        out[name] = dict(frames_per_s=n_frames / chunk_s, chunk_s=chunk_s,
                         ontology_embedding_s=onto_s, rerank_s=rerank_total,
                         peak_memory_gib=peak / 2**30, profile=prof,
                         launches=launches, ontology_launches=onto_launches,
                         frames=n_frames, videos=VT_VIDEOS,
                         sample=res[next(iter(res))]["aggregated_tokens"])
        log(f"visual tokenization ({name}):", json.dumps(out[name]))
        del cache
    del blip_engine, clip_engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the prompt side: SBERT (all-mpnet-base-v2 at full width), in-context
# selection, QA answer mapping, VLEP (phase 14)
# ---------------------------------------------------------------------------

# pipeline/README.md's paper recipe: caption selection with SHOT 10 and N 5
# over MSR-VTT 1k-A's 1000 test videos; QA selection with SHOT 5 and N 5 over
# 1000 questions; the QA answer mapping of 4096 predictions onto a
# 1500-answer list; VLEP multichoice over 500 examples of 2 events each. The
# encoder's defaults (make_torch_sbert_encoder): 64 texts of 128 tokens a
# batch, bf16
SB_QUERIES, SB_FRAMES, SB_TRAIN_VIDEOS = 1000, 8, 100
SB_CAPTION_SHOT, SB_QA_SHOT, SB_N = 10, 5, 5
SB_ANSWERS, SB_PREDICTIONS, SB_VLEP = 1500, 4096, 500
SB_BATCH, SB_LEN = 64, 128
SB_NORM_TOL = 1e-3  # |norm - 1| of every embedding
SB_INSTRUCTION = "Instruction: write a one-sentence caption of the video."
# the card's fp32 encode against the CPU's: only the summation order
# differs, so each errs from the exact (fp64) result by about as much as the
# other; their difference is at most the sum of the two errors, and the
# factor 4 over the CPU's own error leaves 2x for the spread between the two
# orders' errors. An encode with another rounding (TF32 products, bf16)
# errs by orders of magnitude more
SB_F32_FACTOR = 4.0
SB_CATEGORIES = ("objects", "attributes", "scenes", "verbs")


def _sb_words(rng, lo, hi):
    """lo..hi words of the synthetic vocab (tokenizer.write_mpnet_vocab)."""
    return " ".join(f"word{rng.randrange(200, 30000)}" for _ in range(rng.randint(lo, hi)))


def _sb_stage(root, name, vids, rng):
    """A visual-tokenization output (8 frames, VT_TOPK terms per category per
    frame) and a CapFilt pair (8 frame captions) for `vids`, as the CLIs
    write them."""
    d = os.path.join(root, name)
    os.makedirs(d)
    vt = {v: {"frame_tokens": [{k: [_sb_words(rng, 1, 2) for _ in range(VT_TOPK)]
                                for k in SB_CATEGORIES} for _ in range(SB_FRAMES)],
              "caption": _sb_words(rng, 8, 14)} for v in vids}
    caps = {v: [_sb_words(rng, 6, 12) for _ in range(SB_FRAMES)] for v in vids}
    for fname, obj in (("visual_tokens.json", vt), ("video_text_CapFilt.json", caps),
                       ("video_text_Cap.json", caps)):
        with open(os.path.join(d, fname), "w") as f:
            json.dump(obj, f)
    return d, vt, caps


def _sb_snapshot(root, device):
    """A full-width all-mpnet-base-v2 snapshot of synthetic sin-fill weights
    (utils/synth.py), as make_sbert_encoder reads one: config.json, the
    full-width vocab.txt, an HF-keyed pytorch_model.bin."""
    from vidil_tpu_torch.models import convert, mpnet
    from vidil_tpu_torch.tokenizer import write_mpnet_vocab
    from vidil_tpu_torch.utils.synth import synth_tree

    cfg = mpnet.MPNetConfig()
    params = convert.from_jax_params(synth_tree(mpnet.mpnet_shapes(cfg), device, salt=6.0))
    snap = os.path.join(root, "sbert")
    os.makedirs(snap)
    torch.save(mpnet.to_hf_state_dict(params), os.path.join(snap, "pytorch_model.bin"))
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump({"model_type": "mpnet", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "relative_attention_num_buckets": cfg.relative_attention_num_buckets,
                   "layer_norm_eps": cfg.layer_norm_eps, "pad_token_id": cfg.pad_token_id}, f)
    write_mpnet_vocab(os.path.join(snap, "vocab.txt"))
    return snap, cfg, params


def _sb_checked(encoder, stats):
    """`encoder` with every call timed (it ends in a copy to the host) and
    every embedding checked: finite, stats["width"] wide, norm 1 within
    SB_NORM_TOL."""
    def encode(texts):
        t0 = time.perf_counter()
        out = encoder(texts)
        stats["calls"].append((len(texts), time.perf_counter() - t0))
        err = float(np.abs(np.linalg.norm(out, axis=-1) - 1.0).max())
        if (out.shape != (len(texts), stats["width"]) or not np.isfinite(out).all()
                or err > SB_NORM_TOL):
            raise SystemExit(f"sbert: bad embeddings {out.shape}, |norm - 1| {err}")
        stats["max_norm_err"] = max(stats["max_norm_err"], err)
        return out
    return encode


def _sb_run_cli(argv, stats):
    """The in-context CLI's main (vidil_tpu_torch.generate_prompts_random_
    prefix_in_context_selection) on `argv`: its encoder, made by its own
    route from the snapshot, checked by _sb_checked; its selection stage
    timed. Returns the encoder and the selection seconds."""
    from vidil_tpu_torch import generate_prompts_random_prefix_in_context_selection as cli

    made, sel_s = [], []
    make, select = cli.make_sbert_encoder, cli.save_prompt_lines_with_in_context_selection

    def make_checked(*a, **kw):
        made.append(make(*a, **kw))
        return _sb_checked(made[-1], stats)

    def timed_select(*a, **kw):
        t0 = time.perf_counter()
        select(*a, **kw)
        sel_s.append(time.perf_counter() - t0)

    cli.make_sbert_encoder, cli.save_prompt_lines_with_in_context_selection = \
        make_checked, timed_select
    try:
        args = cli.parse_args(argv)
        cli.main(args)
    finally:
        cli.make_sbert_encoder, cli.save_prompt_lines_with_in_context_selection = make, select
    return made[0], sel_s[0], args


def _sb_check_prompts(args, vt, caps, queries, count_key):
    """The CLI's jsonl and idx map: one prompt per query, each the
    instruction, the N selected examples and the query's own prompt, in
    that order; the idx map the queries'. Returns the queries' comparing
    strings."""
    from vidil_tpu_torch.pipeline.generate_prompts import (
        _extract_compare_str,
        base_config_from_args,
    )
    from vidil_tpu_torch.pipeline.prompts import Prompt

    out = os.path.join(args.output_dir, f"temp_{args.gpt3_temperature}_gpt3_queries")
    with open(out + ".jsonl") as f:
        prompts = [json.loads(line)["prompt"] for line in f]
    with open(out + "__idx_2_videoid.json") as f:
        idx = json.load(f)
    if len(prompts) != len(queries) or idx != {str(i): q for i, (q, _) in enumerate(queries)}:
        raise SystemExit(f"prompts: {len(prompts)} lines, idx map of {len(idx)}, want "
                         f"{len(queries)} queries in order")
    config = base_config_from_args(args, out + ".jsonl", {})
    dummy = Prompt("", seed=42)
    compare = []
    for prompt, (key, qa) in zip(prompts, queries):
        vid = key if isinstance(key, str) else key[0]
        query = dummy.construct_prompt(vid, vt[vid], caps, config, *(qa or (None, None)), None)
        if not (prompt.startswith(args.instruction_line + "\n\n") and prompt.endswith(query)
                and prompt.count(count_key) == args.N + 1):
            raise SystemExit(f"prompt for {key} lacks the instruction, the {args.N} examples or "
                             f"the query: {prompt!r}")
        compare.append(_extract_compare_str(query, args.comparing_target))
    return compare


def _sb_bound_ms(cfg, B, L):
    """Least time of one encode: its products at the bf16 peak (4 D^2 + 2 D F
    weights per token, 2 flops each, and the attention's 4 L^2 Dh per head),
    above the bytes of its weights (bf16) and activations."""
    D, F_, N = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    flops = N * (2 * B * L * (4 * D * D + 2 * D * F_)
                 + 4 * B * cfg.num_heads * L * L * (D // cfg.num_heads))
    # bf16 weights, the ids and mask (int64), the embedding rows gathered
    # (fp32, word and position), the fp32 embeddings written
    nbytes = N * 2 * (4 * D * D + 2 * D * F_) + 2 * B * L * 8 + 2 * B * L * D * 4 + B * D * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / PEAK_BYTES * 1e3
    return flops, (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _mpnet_f64(params, ids, mask, cfg):
    """A plain float64 MPNet forward with SBERT pooling, written apart from
    models/mpnet.py: the exact result the fp32 encodes are held to."""
    from vidil_tpu_torch.models.mpnet import compute_position_bias

    def p(t):
        return t.double()

    def ln(n, x):
        return F.layer_norm(x, (x.shape[-1],), p(n["scale"]), p(n["bias"]), cfg.layer_norm_eps)

    def lin(n, x):
        return x @ p(n["kernel"]) + p(n["bias"])

    B, L = ids.shape
    H, Dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    nonpad = (ids != cfg.pad_token_id).long()
    pos = torch.cumsum(nonpad, 1) * nonpad + cfg.pad_token_id
    x = ln(params["emb_norm"], p(params["word_embeddings"]["embedding"])[ids]
           + p(params["position_embeddings"]["embedding"])[pos])
    bias = (compute_position_bias(p(params["relative_attention_bias"]), L)
            + (1.0 - mask[:, None, None, :].double()) * -10000.0)
    for layer in params["layers"]:
        q, k, v = (lin(layer[n], x).view(B, L, H, Dh).transpose(1, 2) for n in ("q", "k", "v"))
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(Dh) + bias, dim=-1) @ v
        x = ln(layer["attn_norm"], lin(layer["o"], a.transpose(1, 2).reshape(B, L, -1)) + x)
        x = ln(layer["out_norm"], lin(layer["fc2"], F.gelu(lin(layer["fc1"], x))) + x)
    m = mask[:, :, None].double()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True)


def run_prompt_side(fa, fm, fvb, device, card):
    """Phase 14: the prompt side at full width on the card (see the module
    docstring). Runs no kernel of the TPU's: every count must stay 0."""
    import random

    from vidil_tpu_torch.evals import qa as qa_eval
    from vidil_tpu_torch.evals import vlep
    from vidil_tpu_torch.models.convert import to_device
    from vidil_tpu_torch.models.layers import cast_linears
    from vidil_tpu_torch.models.mpnet import make_torch_sbert_encoder, sbert_embed
    from vidil_tpu_torch.pipeline.generate_prompts import _extract_compare_str, get_prompt_prefix
    from vidil_tpu_torch.tokenizer import MPNetTokenizer

    t_phase = time.time()
    rng = random.Random(14)
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        snap, cfg, params = _sb_snapshot(tmp, device)
        queries = [f"q{i}" for i in range(SB_QUERIES)]
        train = [f"t{i}" for i in range(SB_TRAIN_VIDEOS)]
        qdir, qvt, qcaps = _sb_stage(tmp, "query", queries, rng)
        tdir, tvt, tcaps = _sb_stage(tmp, "train", train, rng)
        with open(os.path.join(tmp, "train_ann.json"), "w") as f:
            json.dump({v: [tvt[v]["caption"]] for v in train}, f)
        qa = {v: [{"question": f"what is the {_sb_words(rng, 1, 2)} doing with "
                               f"{_sb_words(rng, 1, 3)}?", "answer": _sb_words(rng, 1, 2)}]
              for v in queries + train}
        with open(os.path.join(tmp, "qa.json"), "w") as f:
            json.dump(qa, f)

        def argv(task, shot, target, extra=()):
            return ["--prompt_task", task, "--visual_tokens_dir", qdir,
                    "--frame_captions_dir", qdir, "--train_dataset_visual_tokens_dir", tdir,
                    "--train_dataset_frame_captions_dir", tdir,
                    "--trainset_json_ann", os.path.join(tmp, "train_ann.json"),
                    "--output_dir", os.path.join(tmp, f"out_{task}"),
                    "--instruction_line", SB_INSTRUCTION, "--shot", str(shot),
                    "--N", str(SB_N), "--comparing_target", target, "--sbert_model", snap,
                    "--device", device.type, *extra]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in (fa, fm, fvb):
            m.reset_launch_counts()
        stats = {"calls": [], "max_norm_err": 0.0, "width": cfg.hidden_size}
        # caption selection
        enc16, cap_s, cap_args = _sb_run_cli(argv("caption", SB_CAPTION_SHOT, "caption"), stats)
        single = [s for n, s in stats["calls"] if n == 1]
        qtexts = _sb_check_prompts(cap_args, qvt, qcaps, [(v, None) for v in queries],
                                   "Video Caption:")
        # QA selection
        n_calls = len(stats["calls"])
        _, qa_s, qa_args = _sb_run_cli(
            argv("qa", SB_QA_SHOT, "question",
                 ("--question_answer_path", os.path.join(tmp, "qa.json"))), stats)
        _sb_check_prompts(qa_args, qvt, qcaps,
                                 [([v, 0], (qa[v][0]["question"], qa[v][0]["answer"]))
                                  for v in queries], "Answer:")
        single_qa = [s for n, s in stats["calls"][n_calls:] if n == 1]
        checked = _sb_checked(enc16, stats)
        # QA answer mapping
        answers = [_sb_words(rng, 1, 3) for _ in range(SB_ANSWERS)]
        gt = os.path.join(tmp, "qa_gt.jsonl")
        with open(gt, "w") as f:
            for _ in range(SB_PREDICTIONS):
                f.write(json.dumps({"question": "q?", "answer": rng.choice(answers)}) + "\n")
        preds = [{"question_id": i, "answer": _sb_words(rng, 1, 4)}
                 for i in range(SB_PREDICTIONS)]
        t0 = time.perf_counter()
        acc = qa_eval.evaluate_generation_result(preds, gt, answers, encoder=checked)
        map_s = time.perf_counter() - t0
        if not 0.0 <= acc <= 1.0:
            raise SystemExit(f"qa answer mapping: accuracy {acc}")
        # VLEP multichoice
        data = {str(i): {"video_id": f"v{i}", "events": [_sb_words(rng, 4, 9),
                                                          _sb_words(rng, 4, 9)],
                         "answer": i % 2} for i in range(SB_VLEP)}
        results = {k: _sb_words(rng, 4, 9) for k in data}
        t0 = time.perf_counter()
        lines = vlep.eval_multichoice(results, data, os.path.join(tmp, "vlep.jsonl"),
                                      encoder=checked)
        vlep_s = time.perf_counter() - t0
        if len(lines) != SB_VLEP or any(line["pred_ans"] not in (0, 1) for line in lines):
            raise SystemExit(f"vlep: {len(lines)} lines, want {SB_VLEP} with 0/1 answers")
        path_s = time.time() - t_phase
        peak = torch.cuda.max_memory_allocated()
        launches = {**fa.launch_counts, **fm.launch_counts, **fvb.launch_counts}
        if any(launches.values()):
            raise SystemExit(f"prompt side: a TPU kernel's port launched: {launches} (MPNet's "
                             "biased attention and FFN are plain, as in the reference)")

        # the encoder alone: one 64 x 128 batch and one sentence, as the
        # reference calls it per query; bf16, the encoder's own cast weights
        tok = MPNetTokenizer(os.path.join(snap, "vocab.txt"))
        p16 = cast_linears(params, torch.bfloat16)
        enc = tok(qtexts[:SB_BATCH], padding="max_length", truncation=True, max_length=SB_LEN)
        ids, mask = (torch.from_numpy(a).to(device) for a in (enc.input_ids, enc.attention_mask))
        ids1, mask1 = ids[:1].clone(), mask[:1].clone()
        with torch.no_grad():
            batch_ms = time_ms(lambda: sbert_embed(p16, ids, mask, cfg, dtype=torch.bfloat16))
            batch_dev, batch_kernels = device_profile(
                lambda: sbert_embed(p16, ids, mask, cfg, dtype=torch.bfloat16))
            one_ms = time_ms(lambda: sbert_embed(p16, ids1, mask1, cfg, dtype=torch.bfloat16))
            one_host = host_us(lambda: sbert_embed(p16, ids1, mask1, cfg,
                                                   dtype=torch.bfloat16)) / 1e3
            one_dev, one_kernels = device_profile(
                lambda: sbert_embed(p16, ids1, mask1, cfg, dtype=torch.bfloat16))
            if not batch_kernels or not one_kernels:
                raise SystemExit("sbert: the encode ran no CUDA kernel")
            flops, (bound, bound_by) = _sb_bound_ms(cfg, SB_BATCH, SB_LEN)
            _, (bound1, bound1_by) = _sb_bound_ms(cfg, 1, SB_LEN)
            # fp32 on the card against fp32 on the CPU, both against fp64
            gpu32 = sbert_embed(params, ids, mask, cfg).double()
            ref64 = _mpnet_f64(params, ids, mask, cfg)
            cpu32 = sbert_embed(to_device(params, "cpu"), ids.cpu(), mask.cpu(), cfg)
            cpu32 = cpu32.double().to(device)
        diff = float((gpu32 - cpu32).abs().max())
        err_cpu, err_gpu = (float((x - ref64).abs().max()) for x in (cpu32, gpu32))
        if not diff <= SB_F32_FACTOR * err_cpu:
            raise SystemExit(f"sbert fp32: card vs CPU max |diff| {diff:.3g} over the bar "
                             f"{SB_F32_FACTOR} x the CPU's own fp32 error {err_cpu:.3g} (card's "
                             f"{err_gpu:.3g})")
        # reported: the bf16 top-N selection against the fp32 one on the card
        cfg_prefix = {"prompt_task": "caption", "add_objects": True, "add_events": False,
                      "add_attributes": True, "add_scenes": False,
                      "add_original_caption": True, "add_frame_captions": True,
                      "add_ASR": False, "add_answer": True,
                      "prompt_temporal_template": "temporal_natural",
                      "visual_token_aggregation_version": "v2", "topk": 4,
                      "caption_all_video": True, "permutate": -1,
                      "output_path": os.path.join(tmp, "agree.jsonl")}
        _, examples, _ = get_prompt_prefix(tvt, tcaps, tcaps, sorted(train), SB_INSTRUCTION,
                                           cfg_prefix, None, None, SB_CAPTION_SHOT, 42)
        support = [_extract_compare_str(e, "caption") for e in examples]
        enc32 = make_torch_sbert_encoder(params, cfg, tok, dtype=torch.float32, device=device)
        tops = []
        for e in (enc16, enc32):
            s, q = e(support), e(qtexts)
            tops.append(np.argsort(q @ s.T, axis=1)[:, -SB_N:])
        agree = float((tops[0] == tops[1]).all(axis=1).mean())

    out.update(
        queries=SB_QUERIES,
        caption_selection_s=cap_s, caption_selection_ms_per_query=cap_s / SB_QUERIES * 1e3,
        caption_queries_per_s=SB_QUERIES / cap_s,
        qa_selection_s=qa_s, qa_selection_ms_per_query=qa_s / SB_QUERIES * 1e3,
        qa_queries_per_s=SB_QUERIES / qa_s,
        single_encode_call_ms_median=statistics.median(single + single_qa) * 1e3,
        single_encode_calls=len(single) + len(single_qa),
        answer_mapping_s=map_s, answer_mapping_accuracy=acc, vlep_s=vlep_s,
        vlep_examples=SB_VLEP, path_s=path_s, peak_memory_gib=peak / 2**30,
        launches=launches, max_norm_err=stats["max_norm_err"],
        batch={"shape": [SB_BATCH, SB_LEN], "ms": batch_ms,
               "sentences_per_s": SB_BATCH / batch_ms * 1e3,
               "device_ms": batch_dev, "launches": sum(n for _, n in batch_kernels.values()),
               "tflops": flops / batch_dev / 1e9, "bound_ms": bound, "bound_by": bound_by,
               "top": sorted(([k[:60], ms, n] for k, (ms, n) in batch_kernels.items()),
                             key=lambda r: -r[1])[:5]},
        single={"shape": [1, SB_LEN], "ms": one_ms, "host_enqueue_ms": one_host,
                "device_ms": one_dev, "launches": sum(n for _, n in one_kernels.values()),
                "bound_ms": bound1, "bound_by": bound1_by},
        fp32_check={"max_abs_diff_card_vs_cpu": diff, "cpu_err_vs_f64": err_cpu,
                    "card_err_vs_f64": err_gpu, "bar": SB_F32_FACTOR * err_cpu},
        bf16_vs_fp32_topn_agreement=agree, phase_s=time.time() - t_phase)
    del params, p16, enc16, enc32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# BLIP video retrieval (eval and fine-tune) and video pretraining (phase 15)
# ---------------------------------------------------------------------------

def bench_tokenizer():
    """BLIP's tokenizer over the full-size bench vocab (30524 ids)."""
    import os

    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_bench_vocab

    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        write_bench_vocab(vocab)
        return BlipTokenizer(vocab)


def retrieval_corpus(tok):
    """RET_VIDEOS captions (the bench vocab's tokN words, one token each):
    5-20 words, MSR-VTT's run about 9, and one in a hundred of 33-40 words,
    past the tokenizer's 35-token cap, so the trimmed length is the cap, as
    in a corpus whose longest caption reaches it; and that trimmed text
    length (`trimmed_pad_len`, as the evaluator computes it)."""
    from vidil_tpu_torch.tokenizer import trimmed_pad_len

    rng = np.random.default_rng(10)
    lengths = np.where(rng.random(RET_VIDEOS) < 0.01, rng.integers(33, 41, RET_VIDEOS),
                       rng.integers(5, 21, RET_VIDEOS))
    texts = [" ".join(f"tok{i}" for i in rng.integers(0, 30000, int(n))) for n in lengths]
    enc = tok(texts, padding="max_length", truncation=True, max_length=35)
    return texts, trimmed_pad_len(enc.attention_mask)


def _retrieval_params(vit_cfg, med_cfg, device, salt):
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    params = convert.from_jax_params(synth_tree(blip.blip_retrieval_shapes(vit_cfg, med_cfg),
                                                device, salt=salt))
    params["temp"].fill_(0.07)
    return params


def run_retrieval_eval(fa, fvb, device, tok, texts, text_len):
    """Phase 15a: RetrievalEvaluator at the shipped yaml's settings over
    RET_VIDEOS synthetic videos of 8 noise frames and `texts`, bf16: text
    features, video features (kept on the device), then score_matrices'
    v2t and bucketed t2v reranks. K1 must launch 12 times per dispatched
    rerank block (each block's (8, 12, 64 L, 64) fold over (8, 12, 1576,
    64) passes the reference's gate) and nothing else may launch; every
    row keeps exactly k_test scores above -100, all finite. Then one
    dispatch profiled, the eval's dispatch loop timed, K1's device ms at
    the block's fold (in the dispatch, and back to back beside SDPA's), and
    one rerank block in situ: each of its K1 launches against the twin on
    the same inputs (the bar, ATOL x max(1, max |o|)), and its ITM logits
    through K1, SDPA and an fp32 attention against those through the twin
    (K1's within WITNESS_FACTOR x the farther witness's distance)."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.evals.retrieval import RetrievalEvaluator, itm_eval

    vit_cfg = ViTConfig.from_name("base", 224)
    med_cfg = _med_cfg(vit_cfg)
    params = _retrieval_params(vit_cfg, med_cfg, device, salt=4.0)
    kw = dict(k_test=RET_K, dtype=torch.bfloat16, rows_per_batch=RET_ROWS,
              blocks_per_dispatch=RET_BLOCKS)
    ev = RetrievalEvaluator(params, vit_cfg, med_cfg, tok, **kw)
    gen = torch.Generator(device=device).manual_seed(11)

    def video_batches():  # the yaml's batch_size_test 8, normalized noise
        for _ in range(RET_VIDEOS // 8):
            yield torch.randn((8, RET_FRAMES, 224, 224, 3), generator=gen, device=device)

    times = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name] = time.time() - t
            return out
        return run

    ev._rerank_rows = timed("v2t_rerank_s", ev._rerank_rows)
    ev._rerank_t2v_bucketed = timed("t2v_rerank_s", ev._rerank_t2v_bucketed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    fvb.reset_launch_counts()
    t0 = time.time()
    text_embeds, text_ids, text_atts = ev.compute_text_features(texts)
    t1 = time.time()
    vf, ve = ev.compute_video_features(video_batches())
    torch.cuda.synchronize()
    t2 = time.time()
    v2t, t2v = ev.score_matrices(vf, ve, text_embeds, text_ids, text_atts)
    t3 = time.time()
    launches = _counts(fa, fvb)
    peak = torch.cuda.max_memory_allocated()

    L = text_ids.shape[1]
    sims = ve @ text_embeds.T
    v2t_blocks = math.ceil(RET_VIDEOS / RET_ROWS)
    vids_b, txts_b, bucket_vid, bucket_txt, bucket_real = ev.t2v_plan(sims.T)
    dispatched = {d: math.ceil(n / RET_BLOCKS) * RET_BLOCKS
                  for d, n in (("v2t", v2t_blocks), ("t2v", len(vids_b)))}
    # a block's k_test texts per video memory reach attention_auto's grouped
    # cross-attention as one (8, 12, k_test L, 64) query axis (models/med.py)
    q = torch.empty((RET_ROWS, 12, RET_K * L, 64), device="meta")
    k = torch.empty((RET_ROWS, 12, RET_FRAMES * 197, 64), device="meta")
    gate = fa._flash_profitable(q, k, None)
    want = {name: 0 for name in launches}
    want["flash_attention_fwd"] = med_cfg.num_layers * sum(dispatched.values()) * gate
    if launches != want or L != text_len:
        raise SystemExit(f"retrieval eval: launches {launches}, want {want} (text length {L}, "
                         f"phase 3 checked {text_len})")
    for name, m in (("v2t", v2t), ("t2v", t2v)):
        kept = (m > -100).sum(axis=1)
        if not (np.isfinite(m).all() and (kept == RET_K).all()):
            raise SystemExit(f"retrieval eval: {name} rows keep {sorted(set(kept.tolist()))} "
                             f"scores above -100 (want {RET_K}) or are not finite")
    metrics = itm_eval(v2t, t2v, list(range(RET_VIDEOS)), list(range(RET_VIDEOS)))
    computed = sum(dispatched.values()) * RET_ROWS * RET_K
    scorings = 2 * RET_VIDEOS * RET_K
    per_video = np.bincount(bucket_vid, minlength=RET_VIDEOS)
    rerank_s = times["v2t_rerank_s"] + times["t2v_rerank_s"]
    out = dict(videos=RET_VIDEOS, frames=RET_FRAMES, k_test=RET_K, text_len=int(L),
               text_features_s=t1 - t0, video_features_s=t2 - t1, score_matrices_s=t3 - t2,
               **times, scorings=scorings, scorings_per_s=scorings / rerank_s,
               v2t_blocks=v2t_blocks, t2v_blocks=len(vids_b), dispatched_blocks=dispatched,
               t2v_buckets=len(bucket_vid), t2v_buckets_per_video_max=int(per_video.max()),
               t2v_videos_with_buckets=int((per_video > 0).sum()),
               padding_share=1 - scorings / computed, gate_passes=bool(gate),
               launches=launches, peak_memory_gib=peak / 2**30,
               metrics={k: float(v) for k, v in metrics.items()})
    log("retrieval eval (main path):", json.dumps(out))

    # one dispatch (RET_BLOCKS v2t blocks): host enqueue, wall, device time
    rows_b = np.arange(RET_BLOCKS * RET_ROWS).reshape(RET_BLOCKS, RET_ROWS)
    topk_b = np.ascontiguousarray(np.argsort(sims[rows_b.reshape(-1)], axis=1)[:, ::-1][:, :RET_K]
                                  .reshape(RET_BLOCKS, RET_ROWS, RET_K))
    tids, tatts = ev._put(text_ids).long(), ev._put(text_atts).long()
    rb, tb = ev._put(rows_b), ev._put(topk_b)
    blocks = ev._blocks(vf, tids, tatts)
    blocks(rb, tb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    blocks(rb, tb)
    enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    prof = profile_run(lambda: blocks(rb, tb))
    prof["device_busy_share"] = prof["device_ms"] / (wall * 1e3)
    out["dispatch"] = dict(blocks=RET_BLOCKS, host_enqueue_ms=enqueue * 1e3, wall_ms=wall * 1e3,
                           profile=prof)
    # the eval's own dispatch loop (_dispatch_blocks: indices from the host,
    # one dispatch in flight) over the first RET_REAL_DISPATCHES v2t
    # dispatches: wall time, and device time from a profiled repeat; and the
    # whole v2t rerank's busy share, its dispatches at that device time
    n_real = RET_REAL_DISPATCHES * RET_BLOCKS
    rows_r = np.arange(n_real * RET_ROWS).reshape(n_real, RET_ROWS)
    topk_r = np.ascontiguousarray(np.argsort(sims[rows_r.reshape(-1)], axis=1)[:, ::-1][:, :RET_K]
                                  .reshape(n_real, RET_ROWS, RET_K))
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev._dispatch_blocks(blocks, rows_r, topk_r)
    loop_wall = time.perf_counter() - t
    loop_prof = profile_run(lambda: ev._dispatch_blocks(blocks, rows_r, topk_r))
    per_dispatch = loop_prof["device_ms"] / RET_REAL_DISPATCHES
    out["dispatch_loop"] = dict(
        dispatches=RET_REAL_DISPATCHES, wall_ms=loop_wall * 1e3,
        device_ms=loop_prof["device_ms"], device_busy_share=loop_prof["device_ms"] / (loop_wall * 1e3),
        v2t_rerank_busy_share=per_dispatch * dispatched["v2t"] / RET_BLOCKS
        / (times["v2t_rerank_s"] * 1e3))

    # K1 at the block's fold: its device ms per launch inside the profiled
    # dispatch, and alone, back to back (CUDA events), beside SDPA's
    qv, kv, vv = _main_path_views("retrieval_rerank_fold", gen, device, torch.bfloat16, L)
    out["k1_fold_dispatch_device_ms"] = prof["flash_kernels_ms"] / (
        med_cfg.num_layers * RET_BLOCKS)
    out["k1_fold_back_to_back_ms"] = back_to_back_ms(lambda: fa.flash_attention(qv, kv, vv))
    out["sdpa_fold_back_to_back_ms"] = back_to_back_ms(
        lambda: F.scaled_dot_product_attention(qv, kv, vv))

    # in situ, the first v2t block: each of its K1 launches held against the
    # twin (at the kernel's tiling) on the same q, k, v (the bar: ATOL, set
    # for |o| < 1 as a few bf16 ulps, scaled by max(1, max |o|) to keep the
    # same ulps where the block's deeper layers give |o| > 1); then its ITM
    # logits through K1 and through the twin after one MED layer and after
    # twelve (reported: a bf16 rounding that differs in one call moves
    # every later layer's input)
    te = params["text_encoder"]
    one = RetrievalEvaluator(dict(params, text_encoder=dict(te, layers=te["layers"][:1])),
                             vit_cfg, med_cfg, tok, **kw)
    forward = fa._forward
    calls = []

    def checked(q, k, v, with_lse):
        o = forward(q, k, v, with_lse)
        want = fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype])
        calls.append(((o.float() - want.float()).abs().max().item(),
                      want.float().abs().max().item()))
        return o

    def twin(q, k, v, with_lse):
        return fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype],
                                      return_lse=with_lse)

    # witnesses: the same block with the library's bf16 attention (SDPA), and
    # with the attention in fp32 rounded once to bf16, in K1's place; their
    # logits' distance from the twin's is what any bf16 attention moves them
    def sdpa(q, k, v, with_lse):
        assert not with_lse
        return F.scaled_dot_product_attention(q, k, v)

    def fp32(q, k, v, with_lse):
        assert not with_lse
        return F.scaled_dot_product_attention(q.float(), k.float(), v.float()).to(q.dtype)

    def itm_with(e, attention):
        fa._forward = attention
        try:
            return e._itm_grouped(vf, tids, tatts, rb[0], tb[0])
        finally:
            fa._forward = forward

    situ = {}
    for label, e, n in (("one_layer", one, 1), ("twelve", ev, med_cfg.num_layers)):
        calls.clear()
        a = itm_with(e, checked)
        b = itm_with(e, twin)
        for name, attention in (("sdpa", sdpa), ("fp32", fp32)):
            w = itm_with(e, attention)
            situ[f"{label}_itm_logit_{name}_vs_twin_max_abs_diff"] = (w - b).abs().max().item()
        if len(calls) != n or not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"in-situ rerank block ({label}): {len(calls)} K1 launches, want "
                             f"{n}, or non-finite logits")
        situ[f"{label}_k1_vs_twin_max_abs_err"] = max(err for err, _ in calls)
        situ[f"{label}_k1_max_abs_out"] = max(out for _, out in calls)
        situ[f"{label}_k1_over_bar"] = max(err / (ATOL[torch.bfloat16] * max(1.0, out))
                                           for err, out in calls)
        situ[f"{label}_itm_logit_max_abs_diff"] = (a - b).abs().max().item()
        situ[f"{label}_itm_logit_max_abs"] = b.abs().max().item()
    situ["atol"] = ATOL[torch.bfloat16]
    out["in_situ"] = situ
    if max(situ["one_layer_k1_over_bar"], situ["twelve_k1_over_bar"]) > 1.0:
        raise SystemExit(f"in-situ rerank block: a K1 launch differs from its twin beyond "
                         f"{ATOL[torch.bfloat16]} x max(1, max |o|): {situ}")
    # K1's logits may sit no further from the twin's than WITNESS_FACTOR x the
    # farther witness's: a kernel fault hidden by the scaled per-launch bar
    # would put them well beyond any bf16 attention's
    for label in ("one_layer", "twelve"):
        reach = max(situ[f"{label}_itm_logit_{w}_vs_twin_max_abs_diff"] for w in ("sdpa", "fp32"))
        if situ[f"{label}_itm_logit_max_abs_diff"] > WITNESS_FACTOR * reach:
            raise SystemExit(f"in-situ rerank block ({label}): K1's ITM logits sit beyond "
                             f"{WITNESS_FACTOR} x the bf16 witnesses' distance from the twin's: "
                             f"{situ}")
    del ev, one, vf
    torch.cuda.empty_cache()
    return out


def _momentum_batch(tok, device, tokens, pretrain):
    """One fixed batch of RET_TRAIN_BATCH videos x RET_TRAIN_FRAMES noise
    frames at 224 px and captions of 8 to `tokens` tokens ([CLS], words,
    [SEP], pads), with the [ENC] ids (and for pretraining the [DEC] ids);
    retrieval's idx are the videos' own ids."""
    rng = np.random.default_rng(12)
    B = RET_TRAIN_BATCH
    ids = np.zeros((B, tokens), np.int64)
    mask = np.zeros_like(ids)
    for b in range(B):
        n = int(rng.integers(8, tokens + 1))
        ids[b, :n] = [tok.cls_token_id, *rng.integers(1000, 30000, n - 2), tok.sep_token_id]
        mask[b, :n] = 1
    enc, dec = ids.copy(), ids.copy()
    enc[:, 0], dec[:, 0] = tok.enc_token_id, tok.bos_token_id
    gen = torch.Generator(device=device).manual_seed(13)
    batch = {"video": torch.randn((B, RET_TRAIN_FRAMES, 224, 224, 3), generator=gen,
                                  device=device),
             "text_ids": ids, "enc_ids": enc, "text_mask": mask}
    if pretrain:
        batch["dec_ids"] = dec
    else:
        batch["idx"] = np.arange(B)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def momentum_loop(label, step, state, batch, fa, fvb, want):
    """RET_STEPS steps of a momentum-tower trainer on one fixed batch, each
    with the generator of make_generator(0, step): finite losses, the
    queue pointer advancing by the batch each step, exactly the launches
    `want` in every step; the steady step ms (CUDA events, step 1
    excluded), host enqueue ms, samples/s, peak memory and one profiled
    step."""
    from vidil_tpu_torch.utils.seeding import make_generator

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, enqueue_ms, per_step, ptrs = [], [], [], [], []
    B, Q = RET_TRAIN_BATCH, state.queue.image.shape[1]
    fa.reset_launch_counts()
    fvb.reset_launch_counts()
    for i in range(RET_STEPS):
        before, ptr = _counts(fa, fvb), state.queue.ptr
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        state, m = step(state, batch, 0.4, make_generator(0, i, state.device))
        end.record()
        enqueue_ms.append((time.time() - t0) * 1e3)
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append({k: float(v) for k, v in m.items() if k != "negatives"})
        per_step.append({k: v - before[k] for k, v in _counts(fa, fvb).items()})
        ptrs.append(state.queue.ptr)
        if state.queue.ptr != (ptr + B) % Q:
            raise SystemExit(f"{label}: queue pointer {ptr} -> {state.queue.ptr}, batch {B}")
    launches = _counts(fa, fvb)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: losses", json.dumps(losses))
    log(f"{label}: launches per step", json.dumps(per_step[-1]), "in all", json.dumps(launches))
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise SystemExit(f"{label}: losses not finite: {losses}")
    if any(s != want for s in per_step):
        raise SystemExit(f"{label}: launches per step {per_step}, want {want} each")
    steady = statistics.median(step_ms[1:])
    prof = profile_run(lambda: step(state, batch, 0.4, make_generator(0, RET_STEPS,
                                                                      state.device)))
    prof["device_busy_share"] = prof["device_ms"] / steady
    return state, dict(profile=prof, losses=losses, step_ms=step_ms, enqueue_ms=enqueue_ms,
                       steady_step_ms=steady, steady_enqueue_ms=statistics.median(enqueue_ms[1:]),
                       samples_per_s=B / (steady / 1e3), peak_memory_gib=peak / 2**30,
                       launches=launches, launches_per_step=per_step[-1], queue_ptrs=ptrs,
                       steps=RET_STEPS, batch=B, frames=RET_TRAIN_FRAMES, queue=Q)


def run_retrieval_training(fa, fvb, device, tok):
    """Phase 15b: make_retrieval_train_step at full width (ViT-B/16 224 px
    with the yaml's vit_grad_ckpt, MED-base), synthetic weights, bf16, the
    reference's batch 8 x 4 frames, 35-token captions, queues of 57600. The
    JAX package keeps this step on the classic ViT schedule: at 224 px the
    reference's gate sends the attention to the plain path, and the MED's
    attention carries a bias, so no kernel launches."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.train.retrieval import create_train_state, make_retrieval_train_step

    vit_cfg = ViTConfig.from_name("base", 224, remat=True)
    med_cfg = _med_cfg(vit_cfg)
    state = create_train_state(_retrieval_params(vit_cfg, med_cfg, device, salt=5.0), 1e-4, 0.05,
                               queue_size=RET_QUEUE, seed=0, device=device)
    step = make_retrieval_train_step(vit_cfg, med_cfg, dtype=torch.bfloat16)
    want = {name: 0 for name in _counts(fa, fvb)}
    _, out = momentum_loop("retrieval training", step, state, _momentum_batch(tok, device, 35,
                                                                            False), fa, fvb, want)
    return out


def run_pretraining(fa, fvb, device, tok):
    """Phase 15c: make_pretrain_step at full width (ViT-B/16 224 px with the
    yaml's vit_grad_ckpt, MED from configs/bert_config.json widened to the
    tokenizer's 30524 ids, as pretrain_video does), synthetic weights, bf16,
    batch 8 x 4 frames, 30-token captions, queues of 57600: the default
    fused ViT schedule, 12 K4 + 12 K5 launches for the trained tower and 12
    K4 for the momentum tower per step; then one block of the trained
    tower through K4/K5 and through their twins at the step's 32 frames."""
    import dataclasses
    import os

    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.models.blip_pretrain import synth_pretrain_params
    from vidil_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    vit_cfg = ViTConfig.from_name("base", 224, remat=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    med_cfg = MedConfig.from_json(os.path.join(repo, "configs", "bert_config.json"),
                                  encoder_width=vit_cfg.hidden_size)
    med_cfg = dataclasses.replace(med_cfg, vocab_size=tok.vocab_size)
    state = create_pretrain_state(synth_pretrain_params(vit_cfg, med_cfg, device=device, salt=6.0),
                                  1e-4, 0.05, queue_size=RET_QUEUE, seed=0, device=device)
    step = make_pretrain_step(vit_cfg, med_cfg, dtype=torch.bfloat16)
    n = vit_cfg.num_layers
    want = {name: 0 for name in _counts(fa, fvb)}
    want.update(fused_vit_block_fwd=2 * n, fused_vit_block_bwd=n)
    state, out = momentum_loop("pretraining", step, state,
                               _momentum_batch(tok, device, PRE_TOKENS, True), fa, fvb, want)
    out["in_situ_block"] = in_situ_fused_block(fvb, device,
                                               state.params["visual_encoder"]["blocks"][0],
                                               frames=RET_TRAIN_BATCH * RET_TRAIN_FRAMES)
    return out


def run_retrieval_phase(fa, fvb, device, card, tok, texts, text_len):
    """Phase 15: the retrieval eval, the retrieval fine-tune, pretraining."""
    t_phase = time.time()
    ev = run_retrieval_eval(fa, fvb, device, tok, texts, text_len)
    log(f"retrieval eval: {ev['videos']} videos x {ev['frames']} frames, k_test {ev['k_test']}, "
        f"text length {ev['text_len']}: text features {ev['text_features_s']:.2f} s, video "
        f"features {ev['video_features_s']:.2f} s, v2t rerank {ev['v2t_rerank_s']:.2f} s, t2v "
        f"rerank {ev['t2v_rerank_s']:.2f} s ({ev['scorings_per_s']:.0f} scorings/s), "
        f"{ev['t2v_buckets']} t2v buckets ({ev['t2v_blocks']} blocks, padding share "
        f"{ev['padding_share']:.3f}), one dispatch: host enqueue "
        f"{ev['dispatch']['host_enqueue_ms']:.1f} ms, device "
        f"{ev['dispatch']['profile']['device_ms']:.1f} ms, wall {ev['dispatch']['wall_ms']:.1f} "
        f"ms; peak memory {ev['peak_memory_gib']:.2f} GiB; card {card}")
    log("retrieval eval:", json.dumps(ev))
    out = {"eval": ev}
    for name, fn in (("retrieval_training", run_retrieval_training),
                     ("pretraining", run_pretraining)):
        t = out[name] = fn(fa, fvb, device, tok)
        log(f"{name}: steady step {t['steady_step_ms']:.2f} ms (CUDA events, step 1 excluded; "
            f"host enqueue {t['steady_enqueue_ms']:.2f} ms), busy share "
            f"{t['profile']['device_busy_share']:.3f}, {t['samples_per_s']:.2f} samples/s "
            f"({t['batch']} videos x {t['frames']} frames), peak memory "
            f"{t['peak_memory_gib']:.2f} GiB, card {card}")
        log(f"{name}:", json.dumps(t))
    out["phase_s"] = time.time() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 16: CapFilt's decode and ingest modes, the remaining BLIP model
# functions
# ---------------------------------------------------------------------------

P16_CHUNKS = 2  # chunks per sampled CapFilt run
P16_NATIVE = ((240, 320), (480, 640))  # native frame sizes: an upscale and a downscale to 384
# timings of the compared calls: the median of this many synced calls of
# each, taken in turns (A B .. B A), since the host's speed drifts
P16_REPS = 5
# NLVR2 over 16 pairs (32 images at 384 px), 35-token texts, fusion_layer 6;
# the embedding extractor over 32 images
P16_PAIRS, P16_TEXT, P16_FUSION = 16, 35, 6
# |norm - 1| of an ITC feature: fp32 features 1e-3; bf16 features (the JAX
# package's rounding: the norm and then every quotient rounded to bf16,
# each within its unit roundoff 2**-8 relative) 2 * 2**-8
P16_NORM_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -7}


def _reset_counts(mods):
    for m in mods:
        m.reset_launch_counts()


def _read_counts(mods):
    out = {}
    for m in mods:
        out.update(m.launch_counts)
    return out


def _expect_counts(label, counts, k1):
    """Exactly `k1` K1 launches and no launch of any other kernel."""
    want = {name: 0 for name in counts}
    want["flash_attention_fwd"] = k1
    if counts != want:
        raise SystemExit(f"{label}: launches {counts}, want {want}")


def _synced(fn):
    """(result, host seconds to enqueue, host seconds to finish) of fn."""
    torch.cuda.synchronize()
    t0 = time.time()
    r = fn()
    t1 = time.time()
    torch.cuda.synchronize()
    return r, t1 - t0, time.time() - t0


def _timed_in_turns(fns, reps=P16_REPS):
    """{name: (median seconds, median enqueue seconds, last result)} of the
    calls in `fns`, each synced, taken in turns, the order reversed every
    other round."""
    runs = {name: [] for name in fns}
    names = list(fns)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            runs[name].append(_synced(fns[name]))
    return {name: (statistics.median(x[2] for x in rs), statistics.median(x[1] for x in rs),
                   rs[-1][0]) for name, rs in runs.items()}


def _capfilt_run(engine, mods, chunks, config, seed=None):
    """The CapFilt main path: dispatch_chunk / complete_chunk per chunk, each
    chunk's sampling generator seeded afresh with `seed` (as the CLI does),
    with every launch count zeroed just before and read just after. Returns
    (results, the token rows of every chunk on the host, counts, seconds)."""
    _reset_counts(mods)
    torch.cuda.synchronize()
    t0 = time.time()
    results, seqs = [], []
    for chunk in chunks:
        rng = (None if seed is None
               else torch.Generator(device=engine.device).manual_seed(seed))
        d = engine.dispatch_chunk(chunk, config, rng=rng)
        results.extend(engine.complete_chunk(d))
        seqs.append(d.seqs_dev.cpu())
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = _read_counts(mods)
    for r in results:
        if not (r.unfiltered_text and all(isinstance(t, str) and t for t in r.unfiltered_text)
                and all(isinstance(t, str) for t in r.text)):
            raise SystemExit(f"phase 16: bad CapFilt result {r}")
    for s in seqs:
        if not all(_well_formed(row, engine.tok) for row in s):
            raise SystemExit(f"phase 16: malformed token rows {s[:4].tolist()}")
    return results, torch.cat(seqs), counts, seconds


def _engine(cap, fil, tok, vit_cfg, med_cfg, device, dtype=torch.bfloat16, **kw):
    """A CapFilt engine as phase 4's (3 beams, 20 tokens, beam_group_kv, the
    fused filter) over the given weights, with other decode options."""
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine

    return CapFiltEngine(cap, fil, tok, vit_cfg, med_cfg, num_beams=3, max_length=20,
                         min_length=5, dtype=dtype, beam_group_kv=True, fused_filter=True,
                         device=device, **kw)


def _variant(engine, vit_cfg, med_cfg, **kw):
    """An engine over `engine`'s (bf16) weights with other decode options."""
    return _engine(engine.captioner_params, engine.filterer_params, engine.tok, vit_cfg,
                   med_cfg, engine.device, **kw)


def _agreement(a, b, lp):
    return (a[:, lp:] == b[:, lp:]).float().mean().item()


def p16_sampling(engine, mods, chunks, embeds):
    """16.1: sampled captions through dispatch/complete, twice with one seed
    and once with another; decode seconds beside the beam decode's."""
    cfg = dict(CONFIG, generation_mode="sample")
    runs = [_capfilt_run(engine, mods, chunks, cfg, seed) for seed in (0, 0, 1)]
    for _, _, counts, _ in runs:
        _expect_counts("sampling", counts, 2 * 12 * len(chunks))
    (res_a, seqs_a, _, s_a), (res_b, seqs_b, _, _), (_, seqs_c, _, _) = runs
    if not (torch.equal(seqs_a, seqs_b) and [(r.unfiltered_text, r.text) for r in res_a]
            == [(r.unfiltered_text, r.text) for r in res_b]):
        raise SystemExit("sampling: two runs with one seed differ")
    lp = engine.prompt_length
    if torch.equal(seqs_a[:, lp:], seqs_c[:, lp:]):
        raise SystemExit("sampling: another seed gave the same captions")
    gen = torch.Generator(device=engine.device)
    t = _timed_in_turns({"sample": lambda: engine.generate_sample(embeds, gen.manual_seed(0)),
                         "beam": lambda: engine.generate_beam(embeds)})
    (sample_s, sample_enq, _), (beam_s, beam_enq, _) = t["sample"], t["beam"]
    return {"chunks": len(chunks), "k1_per_chunk": runs[0][2]["flash_attention_fwd"] // len(chunks),
            "seconds_per_run": s_a, "sample_decode_s": sample_s,
            "sample_decode_enqueue_s": sample_enq, "beam_decode_s": beam_s,
            "beam_decode_enqueue_s": beam_enq,
            "other_seed_token_agreement": _agreement(seqs_a, seqs_c, lp),
            "caption": res_a[0].unfiltered_text[0]}


def _smooth_frames(rng, n, H, W):
    """n uint8 RGB frames of a camera's statistics rather than noise's: per
    channel, four random plane waves of up to 6 cycles across the frame
    around mid-grey, plus Gaussian noise of 3 levels (sensor grain); noise
    frames would measure only the resize's response to aliasing."""
    y = np.arange(H, dtype=np.float32)[:, None] / H
    x = np.arange(W, dtype=np.float32)[None, :] / W
    out = np.empty((n, H, W, 3), np.uint8)
    for i in range(n):
        for c in range(3):
            img = np.full((H, W), 128.0, np.float32)
            for _ in range(4):
                fy, fx = rng.uniform(-6, 6, 2)
                img += rng.uniform(10, 35) * np.sin(2 * np.pi * (fy * y + fx * x)
                                                    + rng.uniform(0, 2 * np.pi))
            img += rng.normal(0, 3, (H, W)).astype(np.float32)
            out[i, :, :, c] = np.clip(np.round(img), 0, 255)
    return out


def p16_resize(engine, mods, device):
    """16.2: resize_on_device at an upscale and a downscale, RGB and YUV420:
    the card's resize against the port's CPU resize of the same frames (at
    most 1 uint8 level, on rounding ties), against the host PIL path
    (reported), the encode stage beside the host-resize path's, and one
    CapFilt chunk of native frames through dispatch/complete."""
    from vidil_tpu_torch.ops import image
    from vidil_tpu_torch.pipeline.capfilt import preprocess_frames_pil

    S = 384
    rng = np.random.default_rng(16)
    out = {}
    for H, W in P16_NATIVE:
        rgb = _smooth_frames(rng, N_VIDEOS * N_FRAMES, H, W)
        for fmt in ("rgb", "yuv420"):
            host = image.rgb_to_yuv420(rgb) if fmt == "yuv420" else rgb

            def to_rgb(frames, dev):
                if fmt == "yuv420":
                    return image.yuv420_to_rgb(*(torch.from_numpy(p).to(dev) for p in frames))
                return torch.from_numpy(frames).to(dev).float()

            card = torch.clamp(torch.round(image.resize_bicubic(to_rgb(host, device), S)),
                               0, 255).cpu()
            cpu = torch.clamp(torch.round(image.resize_bicubic(to_rgb(host, "cpu"), S)), 0, 255)
            diff = (card - cpu).abs()
            flips = int((diff > 0).sum())
            if diff.max().item() > 1:
                raise SystemExit(f"resize {H}x{W} {fmt}: the card differs from the CPU by "
                                 f"{diff.max().item()} levels")
            # the host path: PIL resize of the RGB frames (then YUV420 for
            # that transfer format), converted on the card as the encode does
            t0 = time.time()
            pil = preprocess_frames_pil(rgb, S)
            pil_s = time.time() - t0
            pil_in = image.rgb_to_yuv420(pil) if fmt == "yuv420" else pil
            pil_rgb = to_rgb(pil_in, device).round().cpu()
            host_diff = (card - pil_rgb).abs()
            t = _timed_in_turns({"native": lambda: engine.encode_captioner(engine._put(host)),
                                 "resized": lambda: engine.encode_captioner(engine._put(pil_in))})
            dev_encode_s, host_encode_s = t["native"][0], t["resized"][0]
            chunk = [{"video_id": f"r{v}", "text": [],
                      "frames": (image.YUV420Frames(*(p[v * N_FRAMES:(v + 1) * N_FRAMES]
                                                      for p in host))
                                 if fmt == "yuv420" else host[v * N_FRAMES:(v + 1) * N_FRAMES])}
                     for v in range(N_VIDEOS)]
            _, _, counts, chunk_s = _capfilt_run(engine, mods, [chunk], CONFIG)
            _expect_counts(f"resize_on_device {H}x{W} {fmt}", counts, 24)
            out[f"{H}x{W}_{fmt}"] = {
                "card_vs_cpu_tie_flips": flips, "card_vs_cpu_pixels": int(diff.numel()),
                "vs_pil_max_levels": host_diff.max().item(),
                "vs_pil_differing_share": (host_diff > 0).float().mean().item(),
                "encode_native_s": dev_encode_s, "encode_host_resized_s": host_encode_s,
                "pil_resize_host_s": pil_s, "chunk_s": chunk_s,
                "k1_per_chunk": counts["flash_attention_fwd"]}
    return out


def p16_decode_structure(engine, mods, chunk, embeds, frames, vit_cfg, med_cfg, device):
    """16.3: decode_layer_unroll and decode_lazy_reorder, each and both:
    token-identical to the stock decode in fp32 on the card (an fp32 copy
    of the same synthetic weights), agreement in bf16 (reported), decode
    seconds, and each through dispatch/complete (24 K1 a chunk)."""
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    cap32 = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                               device, salt=1.0))
    fil32 = convert.from_jax_params(synth_tree(blip.blip_itm_shapes(vit_cfg, med_cfg),
                                               device, salt=2.0))
    base32 = _engine(cap32, fil32, engine.tok, vit_cfg, med_cfg, device, dtype=torch.float32)
    with torch.no_grad():
        embeds32 = base32.encode_captioner(frames)
        stock32 = base32.generate_beam(embeds32)
    lp = engine.prompt_length
    engines = {"stock": engine}
    out = {}
    for name, kw in (("unroll", dict(decode_layer_unroll=True)),
                     ("lazy", dict(decode_lazy_reorder=True)),
                     ("both", dict(decode_layer_unroll=True, decode_lazy_reorder=True))):
        var32 = _engine(cap32, fil32, engine.tok, vit_cfg, med_cfg, device,
                        dtype=torch.float32, **kw)
        seqs32 = var32.generate_beam(embeds32)
        if not torch.equal(seqs32, stock32):
            raise SystemExit(f"decode {name}: fp32 tokens differ from the stock decode "
                             f"({_agreement(seqs32, stock32, lp):.4f} agree)")
        engines[name] = var = _variant(engine, vit_cfg, med_cfg, **kw)
        _, _, counts, chunk_s = _capfilt_run(var, mods, [chunk], CONFIG)
        _expect_counts(f"decode {name}", counts, 24)
        out[name] = {"fp32_token_identical": True, "chunk_s": chunk_s,
                     "k1_per_chunk": counts["flash_attention_fwd"]}
    t = _timed_in_turns({name: (lambda e=e: e.generate_beam(embeds)) for name, e in engines.items()})
    out["stock_decode_s"], out["stock_decode_enqueue_s"], stock = t["stock"]
    for name in ("unroll", "lazy", "both"):
        s, enq, seqs = t[name]
        out[name].update(decode_s=s, decode_enqueue_s=enq,
                         token_agreement_bf16=_agreement(seqs, stock, lp))
    return out


def p16_nlvr_embedding(mods, device, tok, vit_cfg, med_cfg):
    """16.4: NLVR2 forward and loss over 16 pairs and the embedding extractor
    (itm, itc) over 32 images, bf16, 12 K1 launches per encode (one encode
    each); itc features of unit norm (bf16, and fp32 within 1e-3); the
    return_attn encode (no K1: its maps are the output) with rows summing
    to 1 and its embeddings beside the classic encode's (reported)."""
    from vidil_tpu_torch.models import blip, convert, vit
    from vidil_tpu_torch.models.blip_embedding import blip_embedding_forward
    from vidil_tpu_torch.models.blip_nlvr import nlvr_forward, nlvr_loss
    from vidil_tpu_torch.ops.image import preprocess_any
    from vidil_tpu_torch.utils.synth import synth_tree

    n_img = 2 * P16_PAIRS
    gen = torch.Generator(device=device).manual_seed(5)
    frames = torch.randint(0, 256, (n_img, 384, 384, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    images = preprocess_any(frames, vit_cfg.image_size)
    rng = np.random.default_rng(5)
    texts = [" ".join(f"tok{i}" for i in rng.integers(0, 30000, int(rng.integers(8, 40))))
             for _ in range(n_img)]
    enc = tok(texts, padding="max_length", truncation=True, max_length=P16_TEXT)
    ids = torch.from_numpy(np.asarray(enc.input_ids)).to(device)
    mask = torch.from_numpy(np.asarray(enc.attention_mask)).to(device)
    bf16 = torch.bfloat16
    out = {}
    nlvr = convert.from_jax_params(synth_tree(blip.blip_nlvr_shapes(vit_cfg, med_cfg), device,
                                              salt=4.0))
    targets = torch.arange(P16_PAIRS, device=device) % 2

    def run_nlvr():
        logits = nlvr_forward(nlvr, images[:P16_PAIRS], images[P16_PAIRS:], ids[:P16_PAIRS],
                              mask[:P16_PAIRS], vit_cfg, med_cfg, fusion_layer=P16_FUSION,
                              dtype=bf16)
        return logits, nlvr_loss(logits, targets)

    with torch.no_grad():
        _reset_counts(mods)
        (logits, loss), enq, total = _synced(run_nlvr)
        counts = _read_counts(mods)
        _expect_counts("nlvr", counts, vit_cfg.num_layers)
    if not (tuple(logits.shape) == (P16_PAIRS, 2) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()) and loss.dim() == 0
            and bool(torch.isfinite(loss))):
        raise SystemExit(f"nlvr: bad outputs {logits.shape} {loss}")
    out["nlvr"] = {"pairs": P16_PAIRS, "s": total, "enqueue_s": enq, "loss": loss.item(),
                   "k1": counts["flash_attention_fwd"]}
    del nlvr

    itm = convert.from_jax_params(synth_tree(blip.blip_itm_shapes(vit_cfg, med_cfg), device,
                                             salt=2.0))
    with torch.no_grad():
        _reset_counts(mods)
        scores, enq, total = _synced(lambda: blip_embedding_forward(
            itm, images, ids, mask, vit_cfg, med_cfg, match_head="itm", dtype=bf16))
        counts = _read_counts(mods)
        _expect_counts("embedding itm", counts, vit_cfg.num_layers)
        if not (tuple(scores.shape) == (n_img, 2) and bool(torch.isfinite(scores).all())):
            raise SystemExit(f"embedding itm: bad logits {scores.shape}")
        out["embedding_itm"] = {"s": total, "enqueue_s": enq,
                                "k1": counts["flash_attention_fwd"]}
        for dtype in (bf16, torch.float32):
            _reset_counts(mods)
            (img_f, txt_f, sim), enq, total = _synced(lambda: blip_embedding_forward(
                itm, images, ids, mask, vit_cfg, med_cfg, match_head="itc",
                dtype=None if dtype == torch.float32 else dtype))
            _expect_counts(f"embedding itc {dtype}", _read_counts(mods), vit_cfg.num_layers)
            norms = torch.cat([img_f.float().norm(dim=-1), txt_f.float().norm(dim=-1)])
            dev = (norms - 1).abs().max().item()
            if not (tuple(img_f.shape) == (n_img, 256) and tuple(txt_f.shape) == (n_img, 256)
                    and tuple(sim.shape) == (n_img, n_img) and bool(torch.isfinite(sim).all())
                    and dev <= P16_NORM_TOL[dtype]):
                raise SystemExit(f"embedding itc {dtype}: shapes {img_f.shape} {txt_f.shape} "
                                 f"{sim.shape}, |norm - 1| {dev}")
            out[f"embedding_itc_{str(dtype).split('.')[-1]}"] = {
                "s": total, "enqueue_s": enq, "max_norm_deviation": dev}

        ve = itm["visual_encoder"]
        for label, params in (("one_block", dict(ve, blocks=ve["blocks"][:1])), ("twelve", ve)):
            _reset_counts(mods)
            (emb, maps), enq, total = _synced(lambda: vit.vit_forward(
                params, images, vit_cfg, dtype=bf16, return_attn=True))
            _expect_counts(f"return_attn {label}", _read_counts(mods), 0)
            classic = vit.vit_forward(params, images, vit_cfg, dtype=bf16)
            L = vit_cfg.seq_len
            if not (len(maps) == len(params["blocks"]) and all(
                    tuple(m.shape) == (n_img, vit_cfg.num_heads, L, L) for m in maps)):
                raise SystemExit(f"return_attn: {len(maps)} maps of {maps[0].shape}")
            row_dev = max((m.sum(-1) - 1).abs().max().item() for m in maps)
            if row_dev > 1e-3 or not bool(torch.isfinite(emb).all()):
                raise SystemExit(f"return_attn: rows sum to 1 within {row_dev}")
            out[f"return_attn_{label}"] = {
                "maps": len(maps), "row_sum_max_deviation": row_dev, "s": total,
                "embeddings_vs_classic_max_abs_diff": (emb.float() - classic.float()).abs()
                .max().item(), "embeddings_max_abs": classic.float().abs().max().item()}
            del maps
    return out


def run_phase16(fa, fm, fvb, device, card, tok):
    """Phase 16: the slice's CapFilt modes and model functions at full width
    (BLIP-base/384, synthetic weights, bf16, chunks of 8 videos x 4 frames)."""
    from vidil_tpu_torch.pipeline.capfilt import _concat_frames

    t_phase = time.time()
    mods = (fa, fm, fvb)
    engine, vit_cfg, med_cfg = make_engine(device)
    chunks = make_chunks(yuv_chunks={1})[:P16_CHUNKS]
    frames = engine._put(_concat_frames([c["frames"] for c in chunks[0]]))
    with torch.no_grad():
        embeds = engine.encode_captioner(frames)
    out = {}

    def part(name, fn, *args):
        out[name] = fn(*args)
        log(f"phase 16 {name}:", json.dumps(out[name]))

    part("sampling", p16_sampling, engine, mods, chunks, embeds)
    part("resize_on_device", p16_resize, engine, mods, device)
    part("decode_structure", p16_decode_structure, engine, mods, chunks[0], embeds, frames,
         vit_cfg, med_cfg, device)
    del engine, embeds, frames
    torch.cuda.empty_cache()
    part("models", p16_nlvr_embedding, mods, device, tok, vit_cfg, med_cfg)
    out["phase_s"] = time.time() - t_phase
    out["card"] = card
    return out


# ---------------------------------------------------------------------------
# phase 17: the multi-process runtime (utils/dist, parallel/, the
# data-parallel trainers, the sharded retrieval eval, the CLIs' rank merge)
# ---------------------------------------------------------------------------

P17_WORLD = 2
# CapFilt CLI: 7 videos, as many a chunk as rank 0's shard_range takes
# (`_p17_chunk`): over 2 ranks 4 a chunk (videos 0-3, 4-6), over 4 ranks 2
# (0-1, 2-3, 4-5, 6), so each rank runs one whole chunk of the one
# process's chunks; 16 frames a chunk (4 a video over 2 ranks, 8 over 4),
# whose encodes' attention passes the reference's gate to K1
P17_VIDEOS, P17_CHUNK_FRAMES = 7, 16
# sharded rerank: 30 videos x 8 frames and 30 captions, k_test 16; rows of 8
# (shard_range over 2 ranks: rows 0-15, 16-29; over 4: 0-7, 8-15, 16-23,
# 24-29: whole v2t blocks)
P17_RERANK_VIDEOS, P17_RERANK_K = 30, 16
# two bf16 ranks against one process at the global batch (the ranks' GEMMs
# run at half the rows, so their tilings and accumulation orders differ):
# the loss within 2**-6 relative (a few bf16 units of 2**-8), the gradient
# within 2**-4 of its norm (the per-row differences of bf16 products,
# 2**-8 relative each, accumulated over the backward's depth), and each
# leaf within 2**-3 of its norm (floored at 2**-8 of the whole gradient's,
# `_grad_agreement`); the measured values are printed
P17_LOSS_RTOL, P17_GRAD_NORM_REL, P17_GRAD_LEAF_REL = 2.0 ** -6, 2.0 ** -4, 2.0 ** -3
# the sharded rerank's scores against the one process's: the same pairs
# (the -100 pattern equal) and each score within 2**-12 of max(1, |score|):
# a t2v bucket may hold other texts than the one process's, and its bf16
# products then round in another order. Read on an H100: 3.8e-6 over two
# gloo ranks, 2.3e-5 over four NCCL ranks (PERF.md, PR 11); 2**-12 = 2.4e-4
# is ten times the larger, and a combine or bucketing fault moves a score
# by far more
P17_SCORE_REL = 2.0 ** -12
# the fused caption step: K4 and K5 once per ViT block, no K1 (224 px)
P17_CAPTION_LAUNCHES = {"fused_vit_block_fwd": 12, "fused_vit_block_bwd": 12,
                        "flash_attention_fwd": 0}
P17_RANK_COMMAND = [sys.executable, os.path.abspath(__file__), "--phase17-rank"]
P17_RANK_TIMEOUT = 600


def _p17_chunk(world: int) -> int:
    """Videos a CapFilt chunk over `world` ranks: rank 0's shard."""
    return P17_VIDEOS // world + 1


# the CapFilt CLI's K1 launches per chunk, by world: 24 at 4 frames a video
# (2 ranks; the two encodes), 36 at 8 (4 ranks; the ITM's attention passes
# the gate too)
P17_CAPFILT_K1 = {2: 24, 4: 36}


def _p17_capfilt_bad(recs, one_counts, chunk):
    """The CapFilt CLI's K1 launches: every chunk runs the same program (a
    fixed shape), so each rank's one chunk launches P17_CAPFILT_K1 of its
    world, and the one process that many per chunk."""
    chunks = math.ceil(P17_VIDEOS / chunk)
    per_chunk = P17_CAPFILT_K1[len(recs)]
    bad = _p17_counts_bad(f"one-process CapFilt over {chunks} chunks", one_counts,
                          {"flash_attention_fwd": per_chunk * chunks})
    for r in recs:
        bad += _p17_counts_bad(f"rank {r['rank']} CapFilt", r["capfilt"]["launches"],
                               {"flash_attention_fwd": per_chunk})
    return bad


def _flat_grads(params):
    from vidil_tpu_torch.models.convert import named_leaves

    return [(n, p.grad.detach().float().reshape(-1)) for n, p in named_leaves(params)
            if p.grad is not None]


def _grad_agreement(got, want):
    """Distance of two [(name, flat grad)] lists: over the whole gradient,
    ||g - w|| / ||w||; per leaf, ||g - w|| / max(||w||, 2**-8 ||W||) (W the
    whole gradient: a leaf that is zero in exact arithmetic, such as an
    attention key bias, holds rounding noise of the other leaves' terms,
    at bf16's unit roundoff of their scale), the largest and its leaf."""
    assert [n for n, _ in got] == [n for n, _ in want]
    diff = [float((g - w.to(g.device)).double().norm()) for (_, g), (_, w) in zip(got, want)]
    norm = [float(w.double().norm()) for _, w in want]
    total = math.sqrt(sum(x * x for x in norm))
    leaf = max((d / max(n, 2.0 ** -8 * total), name)
               for d, n, (name, _) in zip(diff, norm, want))
    return {"grad_norm_rel": math.sqrt(sum(d * d for d in diff)) / total,
            "grad_leaf_rel_max": leaf[0], "grad_leaf_worst": leaf[1]}


def _caption_setup(device):
    """Phase 9's fused caption step: ViT-B/16 224 px, MED-base, synthetic
    weights, the 12 x 4-frame batch."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 224, remat=False)
    med_cfg = _med_cfg(vit_cfg)
    params = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                                device, salt=1.0))
    batch, prompt_length = make_train_batch(device)
    return vit_cfg, med_cfg, params, batch, prompt_length


def _caption_step(device, zero1=False):
    """One fused caption step from fresh state, on this rank's rows of the
    batch under a process group: (state, loss, K4/K5/K1 counts of the
    step)."""
    from vidil_tpu_torch.ops import flash_attention as fa, fused_vit_block as fvb
    from vidil_tpu_torch.parallel.dryrun import rank_batch
    from vidil_tpu_torch.parallel.sharding import apply_optimizer_sharding
    from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step

    vit_cfg, med_cfg, params, batch, prompt_length = _caption_setup(device)
    state = create_caption_train_state(params, 1e-4, 0.05, device=device)
    del params
    if zero1:
        state = apply_optimizer_sharding(state, {"optimizer_sharding": "zero1"})
    step = make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=torch.bfloat16)
    batch = rank_batch(batch)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    fvb.reset_launch_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return state, float(m["loss"]), _counts(fa, fvb)


def _retrieval_step(device, tok, negatives=None):
    """Phase 15b's retrieval step (classic ViT schedule, queues of 57600)
    from fresh state, on this rank's rows under a process group, the draws
    from make_generator(0, 0) unless `negatives`: (state, metrics,
    counts)."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.ops import flash_attention as fa, fused_vit_block as fvb
    from vidil_tpu_torch.parallel.dryrun import rank_batch
    from vidil_tpu_torch.train.retrieval import create_train_state, make_retrieval_train_step
    from vidil_tpu_torch.utils.seeding import make_generator

    vit_cfg = ViTConfig.from_name("base", 224, remat=True)
    med_cfg = _med_cfg(vit_cfg)
    state = create_train_state(_retrieval_params(vit_cfg, med_cfg, device, salt=5.0), 1e-4, 0.05,
                               queue_size=RET_QUEUE, seed=0, device=device)
    step = make_retrieval_train_step(vit_cfg, med_cfg, dtype=torch.bfloat16)
    batch = rank_batch(_momentum_batch(tok, device, 35, False))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    fvb.reset_launch_counts()
    state, m = step(state, batch, 0.4, make_generator(0, 0, device), negatives=negatives)
    torch.cuda.synchronize()
    return state, m, _counts(fa, fvb)


def _rerank_setup(device, tok):
    """The sharded rerank's corpus: 30 synthetic videos x 8 noise frames,
    30 captions (one of 35 tokens), phase 15's synthetic retrieval weights."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.evals.retrieval import RetrievalEvaluator

    vit_cfg = ViTConfig.from_name("base", 224)
    med_cfg = _med_cfg(vit_cfg)
    ev = RetrievalEvaluator(_retrieval_params(vit_cfg, med_cfg, device, salt=4.0), vit_cfg,
                            med_cfg, tok, k_test=P17_RERANK_K, dtype=torch.bfloat16,
                            rows_per_batch=RET_ROWS, blocks_per_dispatch=RET_BLOCKS)
    rng = np.random.default_rng(17)
    lengths = [40] + list(rng.integers(5, 21, P17_RERANK_VIDEOS - 1))
    texts = [" ".join(f"tok{i}" for i in rng.integers(0, 30000, int(n))) for n in lengths]
    gen = torch.Generator(device=device).manual_seed(17)
    video = torch.randn((P17_RERANK_VIDEOS, RET_FRAMES, 224, 224, 3), generator=gen,
                        device=device)
    te, ti, ta = ev.compute_text_features(texts)
    vf, ve = ev.compute_video_features([video[i:i + 8] for i in range(0, len(video), 8)])
    return ev, (vf, ve, te, ti, ta)


def _rerank(ev, feats):
    """score_matrices with its K1 launches, and the K1 launches this rank's
    dispatched blocks must make (12 per block; the padding blocks of a
    dispatch run too)."""
    from vidil_tpu_torch.ops import flash_attention as fa
    from vidil_tpu_torch.utils.io import shard_range

    vf, ve, te, ti, ta = feats
    sims = ve @ te.T
    start, end = shard_range(sims.shape[0])
    plan = ev.t2v_plan(sims.T)
    blocks = [math.ceil((end - start) / RET_ROWS), 0 if plan is None else len(plan[0])]
    want = ev.med_cfg.num_layers * sum(math.ceil(n / RET_BLOCKS) * RET_BLOCKS for n in blocks)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    v2t, t2v = ev.score_matrices(vf, ve, te, ti, ta)
    return v2t, t2v, dict(fa.launch_counts), want


def _p17_workspace(root, tok_vocab, chunk):
    """The CapFilt CLI's workspace: P17_VIDEOS synthetic mp4s (320 x 240,
    16 frames), the bench vocab, full-width BLIP-base at 384 px with
    synthetic weights made on the device, bf16, `chunk` videos a chunk."""
    import cv2

    videos = os.path.join(root, "videos")
    os.makedirs(videos, exist_ok=True)
    ann = {}
    for vi in range(P17_VIDEOS):
        w = cv2.VideoWriter(os.path.join(videos, f"video{vi}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
        for i in range(16):
            frame = np.zeros((240, 320, 3), np.uint8)
            frame[:, :, vi % 3] = (i * 13 + vi * 40) % 255
            frame[: 40 + 10 * i, ::3, (vi + 1) % 3] = 200
            w.write(frame)
        w.release()
        ann[f"video{vi}"] = [f"original caption {vi}. a second sentence {vi}"]
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump(ann, f)
    return dict(video_roots=videos, video_formats="mp4",
                train_ann_jsons=os.path.join(root, "ann.json"), frm_sampling_strategy="uniform",
                height=None, width=None, start_time=None, end_time=None, fps=-1, caption=True,
                filter=True, filter_generated_only=False, keep_original_caption=True,
                filter_mode="max_filter", generation_mode="beam", threshold=0.3,
                num_frm_CapFilt=P17_CHUNK_FRAMES // chunk, do_sentence_tokenization=True,
                vit="base",
                image_size=384, bert_vocab=tok_vocab, synthetic_weights=True,
                videos_per_batch=chunk, compute_dtype="bfloat16", data_parallel=True)


def _capfilt_cli(config, out_dir, device):
    """The CapFilt CLI's main into `out_dir`: its K1 launches and files."""
    import argparse

    from vidil_tpu_torch import run_video_CapFilt as cli
    from vidil_tpu_torch.ops import flash_attention as fa

    os.makedirs(out_dir, exist_ok=True)
    args = argparse.Namespace(output_dir=out_dir, device=str(device), seed=42, config="",
                              world_size=1, dist_url="env://", distributed=True)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    cli.main(args, dict(config))
    torch.cuda.synchronize()
    return dict(fa.launch_counts)


def _p17_device():
    """The device of phase 17 (b)'s two ranks: both on cuda:0."""
    return torch.device("cuda", 0)


def _p17_counts_bad(label, counts, want):
    """[message] when a launch count of `counts` differs from `want` (a
    subset of kernel names)."""
    wrong = {k: (counts.get(k), v) for k, v in want.items() if counts.get(k) != v}
    return [f"{label}: launches (got, want) {wrong}"] if wrong else []


def p17_rank(root, backend):
    """One rank of phase 17 (b), env rendezvous: gloo on cuda:0, or NCCL on
    cuda:LOCAL_RANK (one GPU a rank); the caption and retrieval steps on its
    rows of the global batch, the sharded rerank and the CapFilt CLI, each
    with its launch counts zeroed just before and read just after; rank 0
    saves the summed gradients, the losses, the draws and the scores for
    the parent to compare."""
    from vidil_tpu_torch.tokenizer import BlipTokenizer
    from vidil_tpu_torch.utils import dist

    if backend == "gloo":
        device = _p17_device()
        dist.init_distributed_mode(backend="gloo", device=device)
    else:
        dist.init_distributed_mode(backend=backend, device="cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": torch.distributed.get_backend()}
    t0 = time.time()
    state, loss, counts = _caption_step(device)
    out["caption"] = {"loss": loss, "launches": counts, "s": time.time() - t0}
    if rank == 0:
        torch.save(_flat_grads(state.params), os.path.join(root, "caption_grads.pt"))
    del state
    torch.cuda.empty_cache()

    tok = BlipTokenizer(os.path.join(root, "vocab.txt"))
    t0 = time.time()
    state, m, counts = _retrieval_step(device, tok)
    out["retrieval"] = {k: float(v) for k, v in m.items() if k != "negatives"}
    out["retrieval"].update(launches=counts, s=time.time() - t0,
                            negatives=[n.tolist() for n in m["negatives"]])
    if rank == 0:
        torch.save(_flat_grads(state.params), os.path.join(root, "retrieval_grads.pt"))
    del state, m
    torch.cuda.empty_cache()

    t0 = time.time()
    ev, feats = _rerank_setup(device, tok)
    v2t, t2v, counts, want = _rerank(ev, feats)
    out["rerank"] = {"launches": counts, "want_k1": want, "s": time.time() - t0}
    if rank == 0:
        np.savez(os.path.join(root, "rerank_ranks.npz"), v2t=v2t, t2v=t2v)
    del ev, feats
    torch.cuda.empty_cache()

    with open(os.path.join(root, "capfilt.json")) as f:
        config = json.load(f)
    t0 = time.time()
    out["capfilt"] = {"launches": _capfilt_cli(config, os.path.join(root, "capfilt_ranks"),
                                               device),
                      "s": time.time() - t0}
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_distributed()


def p17_use_flash(fa, device):
    """ViT-B/384 encode of 32 frames with use_flash False: no K1 launch
    (plain attention at a shape the gate would send to K1: 12 with it)."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    params = convert.from_jax_params(synth_tree(blip.vit_shapes(ViTConfig.from_name("base", 384)),
                                                device, salt=1.0))
    params = {"visual_encoder": params}
    x = torch.randn((32, 384, 384, 3), generator=torch.Generator(device=device).manual_seed(5),
                    device=device)
    out = {}
    for flag in (False, True):
        cfg = ViTConfig.from_name("base", 384, use_flash=flag)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        with torch.no_grad():
            emb = blip.encode_images(params, x, cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out[f"use_flash_{str(flag).lower()}"] = {"k1": fa.launch_counts["flash_attention_fwd"],
                                                 "finite": bool(torch.isfinite(emb).all())}
    bad = _p17_counts_bad("use_flash false", {"k1": out["use_flash_false"]["k1"]}, {"k1": 0})
    bad += _p17_counts_bad("use_flash true", {"k1": out["use_flash_true"]["k1"]}, {"k1": 12})
    if bad or not all(v["finite"] for v in out.values()):
        raise SystemExit(f"phase 17 use_flash: {bad} {out}")
    return out


def p17_nccl_world_of_one(device):
    """(a) The plain fused caption step twice without a process group; then
    a world of one under NCCL through init_distributed_mode (torchrun's
    variables): the step with the gradient all-reduce, and with ZeRO-1,
    each bitwise equal to the plain step (an all-reduce over one rank is a
    copy), every step with 12 K4 and 12 K5 launches."""
    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.parallel.dryrun import free_port
    from vidil_tpu_torch.parallel.sharding import optimizer_state
    from vidil_tpu_torch.utils import dist

    out, runs = {}, {}

    def run(name, zero1=False):
        t0 = time.time()
        state, loss, counts = _caption_step(device, zero1)
        params = torch.cat([p.detach().reshape(-1) for _, p in named_leaves(state.params)])
        moments = optimizer_state(state.optimizer)
        # (ZeRO-1 consolidates the moments on the host)
        exp_avg = torch.cat([moments[p]["exp_avg"].reshape(-1).to(device)
                             for _, p in named_leaves(state.params)])
        runs[name] = (loss, params, exp_avg)
        out[name] = {"loss": loss, "launches": counts, "s": time.time() - t0}
        bad = _p17_counts_bad(f"phase 17 (a) {name}", counts, P17_CAPTION_LAUNCHES)
        if bad:
            raise SystemExit(bad[0])

    run("plain")
    run("plain_again")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        if not dist.init_distributed_mode(device=device):
            raise SystemExit("phase 17 (a): init_distributed_mode made no process group")
        out.update(backend=torch.distributed.get_backend(), world=dist.get_world_size())
        if out["backend"] != ("nccl" if device.type == "cuda" else "gloo"):
            raise SystemExit(f"phase 17 (a): backend {out['backend']} on {device}")
        run("all_reduce")
        run("zero1", zero1=True)
        base = runs["plain"]
        for name, (loss, params, exp_avg) in runs.items():
            out[name]["bitwise_to_plain"] = bool(loss == base[0] and torch.equal(params, base[1])
                                                 and torch.equal(exp_avg, base[2]))
        del runs, base
        torch.cuda.empty_cache()
        for name in ("all_reduce", "zero1"):
            if not out[name]["bitwise_to_plain"]:
                raise SystemExit(f"phase 17 (a): the {name} step is not bitwise the plain "
                                 f"step's: {out}")
    finally:
        dist.destroy_distributed()
        for k in env:
            os.environ.pop(k, None)
    return out


def p17_ranks(device, tok, root, world=P17_WORLD, backend="gloo"):
    """(b) `world` ranks, fresh subprocesses of this script: gloo on cuda:0
    (the one-card phase), or NCCL on one GPU a rank (`--phase17-world`):
    the caption and retrieval steps at the global batch against one
    process on `device`, the sharded rerank against the one process's
    scores, and the CapFilt CLI's merged files byte-identical."""
    from vidil_tpu_torch.parallel.dryrun import spawn_ranks

    chunk = _p17_chunk(world)
    config = _p17_workspace(root, os.path.join(root, "vocab.txt"), chunk)
    with open(os.path.join(root, "capfilt.json"), "w") as f:
        json.dump(config, f)
    t0 = time.time()
    results = spawn_ranks(world, P17_RANK_COMMAND + [root, backend], root, P17_RANK_TIMEOUT)
    ranks_s = time.time() - t0
    for rank, (rc, stdout, stderr) in enumerate(results):
        if rc != 0:
            raise SystemExit(f"phase 17 (b): rank {rank} exited {rc}:\n{stdout[-2000:]}\n"
                             f"{stderr[-4000:]}")
    recs = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(world)]
    out = {"ranks_s": ranks_s, "ranks": recs}

    # the caption step in one process at the global batch
    state, loss, counts = _caption_step(device)
    bad = _p17_counts_bad("one-process caption", counts, P17_CAPTION_LAUNCHES)
    agree = _grad_agreement(torch.load(os.path.join(root, "caption_grads.pt")),
                            _flat_grads(state.params))
    del state
    torch.cuda.empty_cache()
    out["caption"] = dict(one_process_loss=loss, ranks_loss=recs[0]["caption"]["loss"],
                          loss_rel=abs(recs[0]["caption"]["loss"] - loss) / abs(loss),
                          one_process_launches=counts, **agree)

    # the retrieval step in one process, on the ranks' draws
    draws = recs[0]["retrieval"]["negatives"]
    negatives = tuple(torch.tensor(n, device=device) for n in draws)
    state, m, counts = _retrieval_step(device, tok, negatives=negatives)
    bad += _p17_counts_bad("one-process retrieval", counts, dict.fromkeys(counts, 0))
    agree = _grad_agreement(torch.load(os.path.join(root, "retrieval_grads.pt")),
                            _flat_grads(state.params))
    del state
    torch.cuda.empty_cache()
    out["retrieval"] = dict(one_process_loss=float(m["loss"]),
                            ranks_loss=recs[0]["retrieval"]["loss"],
                            loss_rel=abs(recs[0]["retrieval"]["loss"] - float(m["loss"]))
                            / abs(float(m["loss"])),
                            draws_equal_across_ranks=all(r["retrieval"]["negatives"] == draws
                                                         for r in recs),
                            one_process_launches=counts, **agree)

    # the rerank in one process
    ev, feats = _rerank_setup(device, tok)
    v2t, t2v, counts, want = _rerank(ev, feats)
    del ev, feats
    torch.cuda.empty_cache()
    got = np.load(os.path.join(root, "rerank_ranks.npz"))
    rerank = {"one_process_launches": counts, "one_process_want_k1": want}
    for name, one in (("v2t", v2t), ("t2v", t2v)):
        mine = got[name]
        rerank[f"{name}_pairs_equal"] = bool(((mine == -100) == (one == -100)).all())
        rerank[f"{name}_max_rel"] = float((np.abs(mine - one) / np.maximum(1, np.abs(one))).max())
        rerank[f"{name}_bitwise"] = bool(np.array_equal(mine, one))
    out["rerank"] = rerank

    # the CapFilt CLI in one process
    one_counts = _capfilt_cli(config, os.path.join(root, "capfilt_one"), device)
    files = {}
    for name in ("video_text_Cap.json", "video_text_CapFilt.json"):
        a = open(os.path.join(root, "capfilt_one", name), "rb").read()
        b = open(os.path.join(root, "capfilt_ranks", name), "rb").read()
        files[name] = {"bytes": len(a), "identical": a == b, "videos": len(json.loads(a))}
    out["capfilt"] = {"one_process_launches": one_counts, "files": files}

    for r in recs:
        label = f"rank {r['rank']}"
        bad += _p17_counts_bad(f"{label} caption", r["caption"]["launches"],
                               P17_CAPTION_LAUNCHES)
        bad += _p17_counts_bad(f"{label} retrieval", r["retrieval"]["launches"],
                               dict.fromkeys(r["retrieval"]["launches"], 0))
        bad += _p17_counts_bad(f"{label} rerank", r["rerank"]["launches"],
                               {"flash_attention_fwd": r["rerank"]["want_k1"]})
        if r["backend"] != backend or r["world"] != world:
            bad.append(f"rank {r['rank']}: {r['backend']} world {r['world']}")
    for name in ("caption", "retrieval"):
        o = out[name]
        if not (o["loss_rel"] <= P17_LOSS_RTOL and o["grad_norm_rel"] <= P17_GRAD_NORM_REL
                and o["grad_leaf_rel_max"] <= P17_GRAD_LEAF_REL):
            bad.append(f"{name}: {o}")
    if not out["retrieval"]["draws_equal_across_ranks"]:
        bad.append("the ranks drew different negatives")
    bad += _p17_counts_bad("one-process rerank", counts, {"flash_attention_fwd": want})
    for name in ("v2t", "t2v"):
        if not (rerank[f"{name}_pairs_equal"] and rerank[f"{name}_max_rel"] <= P17_SCORE_REL):
            bad.append(f"rerank {name}: {rerank}")
    bad += _p17_capfilt_bad(recs, one_counts, chunk)
    if not all(f["identical"] and f["videos"] > 0 for f in files.values()):
        bad.append(f"CapFilt files: {files}")
    log_ranks(f"phase 17 (b) {world} {backend} ranks on "
              + ("cuda:0" if backend == "gloo" else "one GPU each"), out)
    if bad:
        raise SystemExit(f"phase 17 (b), {world} {backend} ranks: " + "; ".join(bad))
    return out


def log_ranks(label, out):
    """Each part's line of `p17_ranks`' result, with its launches and
    seconds per rank."""
    for part in ("caption", "retrieval", "rerank", "capfilt"):
        log(f"{label}, {part}:",
            json.dumps({**out[part], "launches_per_rank": [r[part]["launches"]
                                                           for r in out["ranks"]],
                        "seconds_per_rank": [r[part]["s"] for r in out["ranks"]]}))


def run_phase17(fa, device, card, tok):
    """Phase 17: the use_flash switch, (a) and (b)."""
    from vidil_tpu_torch.tokenizer import write_bench_vocab

    t_phase = time.time()
    out = {"use_flash": p17_use_flash(fa, device)}
    log("phase 17 use_flash:", json.dumps(out["use_flash"]))
    torch.cuda.empty_cache()
    out["nccl_world_of_one"] = p17_nccl_world_of_one(device)
    log("phase 17 (a) NCCL world of one:", json.dumps(out["nccl_world_of_one"]))
    with tempfile.TemporaryDirectory() as root:
        write_bench_vocab(os.path.join(root, "vocab.txt"))
        out["two_ranks"] = p17_ranks(device, tok, root)
    out["phase_s"] = time.time() - t_phase
    log(f"phase 17: {out['phase_s']:.1f} s (ranks {out['two_ranks']['ranks_s']:.1f} s); "
        f"card {card}")
    return out


# ---------------------------------------------------------------------------
# phase 18: tensor parallelism, remat "dots", profiling
# ---------------------------------------------------------------------------

P18_VIDEOS, P18_FRAMES, P18_STEPS, P18_MODEL = 4, 4, 3, 2
P18_SCHEDULES = ("classic", "fused")
# every step of a tensor-parallel rank on each ViT-B/384 schedule: the
# classic one, one K1 with lse rows and one K2 per block on the rank's 6
# heads, no K1 without lse rows; the fused one (the trainers' default), one
# K4 and one K5 per block, whole, and no K1 or K2
P18_LAUNCHES = {
    "classic": {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 12,
                "flash_attention_bwd": 12, "fused_vit_block_fwd": 0, "fused_vit_block_bwd": 0,
                "fused_vit_block_attention": 0, "fused_vit_block_attention_bwd": 0},
    "fused": {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 0, "flash_attention_bwd": 0,
              "fused_vit_block_fwd": 12, "fused_vit_block_bwd": 12,
              "fused_vit_block_attention": 0, "fused_vit_block_attention_bwd": 0}}
# the fused schedule's gathered block leaves a step (12 blocks x 6 sharded
# leaves: qkv, fc1 kernels and biases, proj and fc2 kernels)
P18_WHOLE_LEAVES = {"classic": 0, "fused": 72}
# The ranks against one process at the global batch, the first step in
# bf16 and again in fp32. Each row-parallel product (the classic ViT's proj
# and fc2, the MED's out and fc2: 60 in all; the fused schedule's MED
# alone, its ViT blocks running whole) sums the two ranks' fp32 partial
# products and rounds once, as the one process's product rounds its own
# fp32 sum in another order: the steps differ by rounding alone, at most
# one unit of the compute dtype in an element of those products, and the
# synthetic towers amplify such a difference layer by layer (about 3.5x a
# layer, PERF.md), saturating in bf16. The yardstick is measured in the
# same run: the one process's step again with its input frames scaled by
# (1 + eps) of the dtype (2**-7, 2**-23), one unit everywhere at the
# first layer, which the whole depth amplifies. The injections of the
# model axis come later in the towers (each block's proj and fc2, so less
# amplified: a series of ratio 1/3.5 sums to < 1.5 per tower and product)
# and are sparser (only sums that round across a unit differ), so the
# ranks' distances (loss, gradient norm, worst leaf) must lie within
# P18_UNIT_FACTOR times the yardstick's: 2 products x 2 towers x 1.5,
# twice. A fault of the split (a head in the wrong place, a missing sum)
# moves the fp32 gradient by O(1), 10**3 times that.
P18_UNIT_EPS = {"bf16": 2.0 ** -7, "fp32": 2.0 ** -23}
P18_UNIT_FACTOR = 12.0
P18_RANK_COMMAND = [sys.executable, os.path.abspath(__file__), "--phase18-rank"]
P18_RANK_TIMEOUT = 600


def _p18_setup(device):
    """ViT-B/16 at 384 px and MED-base, synthetic weights, no ViT remat (the
    yamls' vit_grad_ckpt), 4 videos x 4 frames of 40-token captions."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import blip, convert
    from vidil_tpu_torch.utils.synth import synth_tree

    vit_cfg = ViTConfig.from_name("base", 384, remat=False)
    med_cfg = _med_cfg(vit_cfg)
    params = convert.from_jax_params(synth_tree(blip.blip_decoder_shapes(vit_cfg, med_cfg),
                                                device, salt=1.0))
    batch, prompt_length = make_train_batch(device, P18_VIDEOS, P18_FRAMES, 384)
    return vit_cfg, med_cfg, params, batch, prompt_length


def _p18_step(schedule, vit_cfg, med_cfg, prompt_length, grid=None, dtype=torch.bfloat16):
    """The caption step on a ViT schedule, computing in `dtype` (None:
    fp32): "classic" sets VIDIL_TPU_TRAIN_FUSED_BLOCK=0 while the step is
    made, "fused" unsets it (the trainers' default pair, K4 and K5)."""
    from vidil_tpu_torch.train.caption import make_caption_train_step

    env = os.environ.pop("VIDIL_TPU_TRAIN_FUSED_BLOCK", None)
    if schedule == "classic":
        os.environ["VIDIL_TPU_TRAIN_FUSED_BLOCK"] = "0"
    try:
        return make_caption_train_step(vit_cfg, med_cfg, prompt_length, dtype=dtype, grid=grid)
    finally:
        os.environ.pop("VIDIL_TPU_TRAIN_FUSED_BLOCK", None)
        if env is not None:
            os.environ["VIDIL_TPU_TRAIN_FUSED_BLOCK"] = env


def _grad_tree(params):
    from vidil_tpu_torch.models.blip_retrieval import _map

    return _map(lambda t: t.grad, params)


def _flat(tree):
    from vidil_tpu_torch.models.convert import named_leaves

    return [(n, t.detach().float().reshape(-1)) for n, t in named_leaves(tree)]


def _timed_steps(step, state, batch, fa, fvb, steps, first):
    """`steps` steps, each with the launch counts zeroed just before it and
    read just after, its CUDA-event ms and its loss; `first(state)` after
    the first step (its gradients)."""
    out = {"losses": [], "step_ms": [], "launches": []}
    for i in range(steps):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        fvb.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        out["launches"].append(_counts(fa, fvb))
        out["step_ms"].append(start.elapsed_time(end))
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["first"] = first(state)
    return state, out


def p18_rank(root, backend, model):
    """One rank of phase 18 (a): the caption step over a (world / model) x
    model grid, env rendezvous (gloo on cuda:0, or NCCL on cuda:LOCAL_RANK),
    on each ViT schedule: P18_STEPS bf16 steps with their launch counts, the
    q shapes that reached the flash kernels and the x shapes that reached
    K4, and the SHA-1 of each fused block's whole gradient (as the gathers'
    backward receives it, before it is sliced) in the first step; then one
    fp32 step from fresh weights; rank 0 saves each first step's gathered
    gradients."""
    import hashlib

    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.ops import flash_attention as fa, fused_vit_block as fvb
    from vidil_tpu_torch.parallel import collectives
    from vidil_tpu_torch.parallel.dryrun import rank_batch
    from vidil_tpu_torch.parallel.mesh import make_grid
    from vidil_tpu_torch.parallel.sharding import gather_params
    from vidil_tpu_torch.train.caption import create_caption_train_state
    from vidil_tpu_torch.utils import dist

    if backend == "gloo":
        device = _p17_device()
        dist.init_distributed_mode(backend="gloo", device=device)
    else:
        dist.init_distributed_mode(backend=backend, device="cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    grid = make_grid(dist.get_world_size() // model, model)
    shapes = {"flash": [], "block": []}
    flash, launch_fwd, gather = fa.flash_attention, fvb._launch_fwd, collectives.gather_from_model
    hashes, capture = [], [True]

    def recorded(q, k, v):
        shapes["flash"].append(tuple(q.shape))
        return flash(q, k, v)

    def block_recorded(args, *rest):
        shapes["block"].append(tuple(args[0].shape))
        return launch_fwd(args, *rest)

    def hashed(x, dim, group):
        out = gather(x, dim, group)
        if capture[0]:
            out.register_hook(lambda g: hashes.append(
                hashlib.sha1(g.detach().cpu().numpy().tobytes()).hexdigest()))
        return out

    def first(st):
        capture[0] = False
        return _flat(gather_params(_grad_tree(st.params), grid)), list(hashes)

    fa.flash_attention, fvb._launch_fwd = recorded, block_recorded
    collectives.gather_from_model = hashed
    out = {}
    for schedule in P18_SCHEDULES:
        shapes["flash"].clear()
        shapes["block"].clear()
        runs, grads = {}, {}
        for name, dtype, steps in (("bf16", torch.bfloat16, P18_STEPS), ("fp32", None, 1)):
            vit_cfg, med_cfg, params, batch, prompt_length = _p18_setup(device)
            state = create_caption_train_state(params, 1e-4, 0.05, device=device, grid=grid)
            del params
            step = _p18_step(schedule, vit_cfg, med_cfg, prompt_length, grid, dtype)
            batch = rank_batch(batch, grid=grid)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hashes.clear()
            capture[0] = True
            t0 = time.time()
            state, run = _timed_steps(step, state, batch, fa, fvb, steps, first)
            run["s"] = time.time() - t0
            grads[name], run["whole_grad_sha1"] = run.pop("first")
            run.update(peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                       param_bytes=sum(p.numel() * p.element_size()
                                       for _, p in named_leaves(state.params)))
            runs[name] = run
            del state
            torch.cuda.empty_cache()
        if dist.get_rank() == 0:
            torch.save({k: [(n, g.cpu()) for n, g in v] for k, v in grads.items()},
                       os.path.join(root, f"tp_grads_{schedule}.pt"))
        del grads
        out[schedule] = dict(runs["bf16"], fp32=runs["fp32"],
                             flash_q_shapes=[list(x) for x in sorted(set(shapes["flash"]))],
                             flash_calls=len(shapes["flash"]),
                             block_x_shapes=[list(x) for x in sorted(set(shapes["block"]))])
    out.update(rank=dist.get_rank(), world=dist.get_world_size(), data=grid.data,
               model=grid.model, backend=torch.distributed.get_backend())
    with open(os.path.join(root, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_distributed()


def p18_tensor_parallel(device, root, world=P18_MODEL, backend="gloo"):
    """(a) the caption step over `world` ranks with a model axis of 2 (two
    gloo ranks on cuda:0, or NCCL on one GPU a rank with `--phase18-world`)
    against one process at the global batch on `device`, on each ViT
    schedule: the launches per step, the flash kernels' q shapes and K4's x
    shapes per rank, the model ranks' losses (and, fused, each block's
    whole gradient) bitwise equal, the first step's loss and gathered
    gradients in bf16 and in fp32 within the P18 bars."""
    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.ops import flash_attention as fa, fused_vit_block as fvb
    from vidil_tpu_torch.parallel.dryrun import spawn_ranks
    from vidil_tpu_torch.train.caption import create_caption_train_state

    t0 = time.time()
    results = spawn_ranks(world, P18_RANK_COMMAND + [root, backend, str(P18_MODEL)], root,
                          P18_RANK_TIMEOUT)
    ranks_s = time.time() - t0
    failed = [f"rank {rank} exited {rc}:\n{stdout[-2000:]}\n{stderr[-3000:]}"
              for rank, (rc, stdout, stderr) in enumerate(results) if rc != 0]
    if failed:
        raise SystemExit("phase 18 (a): " + "\n".join(failed))
    recs = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in range(world)]

    def one_step(schedule, dtype, scale=1.0):
        vit_cfg, med_cfg, params, batch, prompt_length = _p18_setup(device)
        batch["video"] = batch["video"] * scale
        state = create_caption_train_state(params, 1e-4, 0.05, device=device)
        del params
        torch.cuda.reset_peak_memory_stats()
        state, run = _timed_steps(_p18_step(schedule, vit_cfg, med_cfg, prompt_length,
                                            dtype=dtype),
                                  state, batch, fa, fvb, 1, lambda st: _flat(_grad_tree(st.params)))
        run.update(peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                   param_bytes=sum(p.numel() * p.element_size()
                                   for _, p in named_leaves(state.params)))
        del state
        torch.cuda.empty_cache()
        return run

    def distance(grads, loss, ref):
        d = _grad_agreement(grads, ref["first"])
        d["loss_rel"] = abs(loss - ref["losses"][0]) / abs(ref["losses"][0])
        return d

    data = world // P18_MODEL
    frames = P18_VIDEOS * P18_FRAMES // data
    local = {"classic": ([[frames, 12 // P18_MODEL, 577, 64]], []),
             "fused": ([], [[frames, 640, 768]])}
    out = {"ranks_s": ranks_s, "grid": [data, P18_MODEL], "backend": backend}
    bad = []
    for schedule in P18_SCHEDULES:
        want = P18_LAUNCHES[schedule]
        tp_grads = torch.load(os.path.join(root, f"tp_grads_{schedule}.pt"))
        one, agree, unit = {}, {}, {}
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            one[name] = one_step(schedule, dtype)
            nudged = one_step(schedule, dtype, 1.0 + P18_UNIT_EPS[name])
            rec = recs[0][schedule] if name == "bf16" else recs[0][schedule]["fp32"]
            agree[name] = distance(tp_grads[name], rec["losses"][0], one[name])
            unit[name] = distance(nudged["first"], nudged["losses"][0], one[name])
            one[name].pop("first")
        del tp_grads
        keys = ("losses", "step_ms", "launches", "s", "flash_q_shapes", "flash_calls",
                "block_x_shapes", "param_bytes", "peak_memory_gib")
        out[schedule] = {"one_process": one["bf16"], "one_process_fp32": one["fp32"],
                         "agreement": agree, "unit_yardstick": unit,
                         "ranks": [{"rank": r["rank"], **{k: r[schedule][k] for k in keys},
                                    "fp32": r[schedule]["fp32"]} for r in recs]}
        for r in recs:
            run = r[schedule]
            if (run["flash_q_shapes"], run["block_x_shapes"]) != local[schedule]:
                bad.append(f"{schedule} rank {r['rank']}: flash q shapes {run['flash_q_shapes']}"
                           f", K4 x shapes {run['block_x_shapes']}, want {local[schedule]}")
            for i, counts in enumerate(run["launches"] + run["fp32"]["launches"]):
                bad += _p17_counts_bad(f"{schedule} rank {r['rank']} step {i}", counts, want)
            for sha in (run["whole_grad_sha1"], run["fp32"]["whole_grad_sha1"]):
                if len(sha) != P18_WHOLE_LEAVES[schedule]:
                    bad.append(f"{schedule} rank {r['rank']}: {len(sha)} whole block leaves, "
                               f"want {P18_WHOLE_LEAVES[schedule]}")
            if (r["data"], r["model"], r["backend"]) != (data, P18_MODEL, backend):
                bad.append(f"rank {r['rank']}: grid {r['data']} x {r['model']} {r['backend']}")
            if not np.isfinite(run["losses"]).all():
                bad.append(f"{schedule} rank {r['rank']}: a loss is not finite")
        for d in range(data):  # the model ranks of one data rank: the same loss and gradients
            group = [(r[schedule]["losses"] + r[schedule]["fp32"]["losses"],
                      r[schedule]["whole_grad_sha1"] + r[schedule]["fp32"]["whole_grad_sha1"])
                     for r in recs if r["rank"] // P18_MODEL == d]
            if any(g[0] != group[0][0] for g in group):
                bad.append(f"{schedule} data rank {d}: the model ranks' losses differ: "
                           f"{[g[0] for g in group]}")
            if any(g[1] != group[0][1] for g in group):
                bad.append(f"{schedule} data rank {d}: the model ranks' whole block gradients "
                           f"differ")
        bad += _p17_counts_bad(f"one-process {schedule} step", one["bf16"]["launches"][0], want)
        for name in ("bf16", "fp32"):
            for key in ("loss_rel", "grad_norm_rel", "grad_leaf_rel_max"):
                bar = P18_UNIT_FACTOR * max(unit[name][key], P18_UNIT_EPS[name])
                if not agree[name][key] <= bar:
                    bad.append(f"{schedule} {name} {key} {agree[name][key]} over {bar} "
                               f"({P18_UNIT_FACTOR} x one unit's {unit[name][key]})")
    log(f"phase 18 (a) tensor parallel, {data} x {P18_MODEL} {backend} ranks:", json.dumps(out))
    if bad:
        raise SystemExit("phase 18 (a): " + "; ".join(bad))
    return out


def p18_remat_dots(device, fa, fvb):
    """(b) the classic ViT-B/384 caption step in one process with the ViT's
    and the MED's remat full and then "dots" (the plain GEMMs' outputs
    saved): the first step's gradients bitwise equal; two steps each, the
    peak memory and the second step's ms."""
    import dataclasses

    from vidil_tpu_torch.train.caption import create_caption_train_state

    out, grads = {}, {}
    for policy in (None, "dots"):
        vit_cfg, med_cfg, params, batch, prompt_length = _p18_setup(device)
        vit_cfg = dataclasses.replace(vit_cfg, remat=True, remat_policy=policy)
        med_cfg = dataclasses.replace(med_cfg, remat=True, remat_policy=policy)
        state = create_caption_train_state(params, 1e-4, 0.05, device=device)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, run = _timed_steps(_p18_step("classic", vit_cfg, med_cfg, prompt_length), state,
                                  batch, fa, fvb, 2, lambda st: _flat(_grad_tree(st.params)))
        grads[str(policy)] = run.pop("first")
        out[str(policy)] = {"peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                            "step_ms": run["step_ms"][1], "losses": run["losses"],
                            "launches": run["launches"][0]}
        del state
        torch.cuda.empty_cache()
    out["grads_bitwise"] = all(a[0] == b[0] and torch.equal(a[1], b[1])
                               for a, b in zip(grads["None"], grads["dots"]))
    log("phase 18 (b) remat full vs dots (classic ViT-B/384 caption step, bf16):",
        json.dumps(out))
    if not out["grads_bitwise"] or out["None"]["losses"] != out["dots"]["losses"]:
        raise SystemExit(f"phase 18 (b): the dots step is not the full remat's: {out}")
    return out


def p18_profiling(device, fa, root):
    """(c) `utils.profiling.trace` around one CapFilt chunk inside an
    `annotate` range: the written trace names K1's kernel and the range;
    `device_memory_stats()` after it."""
    from torch.autograd import DeviceType

    from vidil_tpu_torch.utils import profiling

    engine, _, _ = make_engine(device)
    rng = np.random.default_rng(18)
    chunk = [{"video_id": f"p18v{v}", "frames": rng.integers(0, 256, (N_FRAMES, 384, 384, 3),
                                                             dtype=np.uint8), "text": []}
             for v in range(N_VIDEOS)]
    engine.complete_chunk(engine.dispatch_chunk(chunk, CONFIG))  # compiles, warms
    log_dir = os.path.join(root, "trace")
    fa.reset_launch_counts()
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("phase18_capfilt_chunk"):
            results = engine.complete_chunk(engine.dispatch_chunk(chunk, CONFIG))
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    text = open(os.path.join(log_dir, files[0])).read() if len(files) == 1 else ""
    out = {"trace_files": files, "trace_bytes": len(text),
           "names_k1_kernel": "flash_fwd_bf16" in text,
           "names_annotate_range": "vidil.phase18_capfilt_chunk" in text,
           "k1_launches": fa.launch_counts["flash_attention_fwd"], "videos": len(results),
           "device_memory_stats": profiling.device_memory_stats(),
           "profiled_kernels": sum(1 for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA)}
    del engine
    torch.cuda.empty_cache()
    log("phase 18 (c) profiling:", json.dumps(out))
    if not (out["names_k1_kernel"] and out["names_annotate_range"] and out["k1_launches"] > 0
            and out["device_memory_stats"].get("bytes_limit")):
        raise SystemExit(f"phase 18 (c): the trace lacks K1 or the range: {out}")
    return out


def run_phase18(fa, fvb, device, card):
    """Phase 18: (a) tensor parallelism over two gloo ranks on the card,
    (b) remat "dots", (c) profiling."""
    t_phase = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        out["tensor_parallel"] = p18_tensor_parallel(device, root)
        out["remat_dots"] = p18_remat_dots(device, fa, fvb)
        out["profiling"] = p18_profiling(device, fa, root)
    out["phase_s"] = time.time() - t_phase
    tp = out["tensor_parallel"]
    log(f"phase 18: {out['phase_s']:.1f} s (ranks {tp['ranks_s']:.1f} s); card {card}")
    for schedule in P18_SCHEDULES:
        t = tp[schedule]
        log(f"phase 18 ({schedule} ViT): tensor-parallel parameter bytes per rank "
            f"{[r['param_bytes'] for r in t['ranks']]} against "
            f"{t['one_process']['param_bytes']} in one process, peak memory per rank "
            f"{[round(r['peak_memory_gib'], 3) for r in t['ranks']]} GiB (one process "
            f"{t['one_process']['peak_memory_gib']:.3f}), step ms per rank "
            f"{[r['step_ms'] for r in t['ranks']]} (one process {t['one_process']['step_ms']}); "
            f"distance from one process (one unit at the input): bf16 {t['agreement']['bf16']} "
            f"({t['unit_yardstick']['bf16']}), fp32 {t['agreement']['fp32']} "
            f"({t['unit_yardstick']['fp32']}); card {card}")
    return out


# ---------------------------------------------------------------------------
# phase 19: from-scratch initialisation (the JAX package's distributions)
# ---------------------------------------------------------------------------

# the init's draws (models/layers.py): std 0.02, truncated at 2 sigma, where a
# unit normal keeps std 0.8796 and kurtosis 2.3656; CLIP's plain normals keep
# std 0.02 and kurtosis 3
P19_STD = 0.02
P19_TRUNC = {"scale": 0.8796, "kurtosis": 2.3656}
P19_STD_RTOL = 0.01
# a leaf's sample std is within 1% of its distribution's where that is 6
# standard errors or more (n >= 1.2e5 truncated); a smaller leaf within 6
# standard errors, sqrt((kurtosis - 1) / (4 n)) relative
P19_STD_SIGMAS = 6.0
P19_PLAIN = {"vision/patch_embed/kernel", "vision/class_embedding", "vision/pos_embed",
             "text/pos_embed", "visual_projection/kernel", "text_projection/kernel"}
P19_CONSTANTS = {"temp": 0.07, "logit_scale": 2.6592}
# (c): the kernels against their plain twins after all 12 blocks, relative
# Frobenius distance. One call differs from its twin by at most one unit of
# its output's rounding (bf16: the unit roundoff 2**-8; fp32: K1's fp32 check
# bar, 2e-5 at |o| < 1); the init's ViT carries a difference from block to
# block with the growth g measured in this run (a 1e-3 pixel perturbation's
# relative effect after 12 blocks over that after 1), so 12 blocks add up to
# at most 12 g units. A gradient carries the forward's sum and the
# backward's own: twice that.
P19_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 2e-5}
P19_LAYERS = 12
P19_FRAMES = N_VIDEOS * N_FRAMES  # a CapFilt chunk's frames at 384 px
# (b): the first step's ITM loss at the init: the head's logit difference d =
# (w1 - w0) . h over a LayerNorm'd [CLS] state (|h|^2 = D) has std
# s = 0.8796 * 0.02 * sqrt(2 D); a third of the rows are positives, so the
# loss is ln(1 + e^d) - d / 3 when the rows move together, at least its
# minimum ln 1.5 + ln 2 / 3 = 0.6365, at most its value at d = 3 s (1.50 at
# D = 768); row-to-row spread only pulls it towards the mean (0.75). Bars: ln 2
# - 0.15 to that value at 3 s. The LM loss over V words: logits of std
# s_lm = 0.8796 * 0.02 * sqrt(D), ln V + s_lm^2 / 2 = ln V + 0.12 at D = 768,
# label smoothing alike; bars ln V - 0.3 to ln V + 0.6
P19_ITM_LOW = math.log(2.0) - 0.15
P19_LM_BARS = (-0.3, 0.6)


def p19_loss_bars(hidden: int, vocab: int) -> dict:
    """The first pretraining step's loss bars at the init (see P19_ITM_LOW)."""
    s = P19_TRUNC["scale"] * P19_STD * math.sqrt(2 * hidden)
    d = 3 * s
    return {"loss_itm": (P19_ITM_LOW, math.log1p(math.exp(d)) - d / 3),
            "loss_lm": tuple(math.log(vocab) + b for b in P19_LM_BARS),
            "itm_logit_diff_std": s}


def _rel_frob(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _p19_expect(label, counts, want):
    """Fail unless the launches `counts` (its zero entries dropped) are
    exactly `want`; return them."""
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise SystemExit(f"phase 19 {label}: launches {got}, want {want}")
    return got


def p19_check_leaves(label, tree, plain=()):
    """The init's leaves against its distributions: constants exact (biases
    zeros, LayerNorm scales ones, P19_CONSTANTS), every truncated leaf within
    2 sigma with its std within the P19_STD_* tolerance of 0.8796 sigma,
    every plain-normal leaf (`plain`) with its std within that of sigma.
    Returns the counts and the worst relative std error."""
    from vidil_tpu_torch.models.convert import named_leaves

    counts = {"constant": 0, "truncated": 0, "plain": 0}
    worst = {"truncated": 0.0, "plain": 0.0}
    for path, t in named_leaves(tree):
        name = path.rsplit("/", 1)[-1]
        want = ({"bias": 0.0, "scale": 1.0}.get(name) if name in ("bias", "scale")
                else P19_CONSTANTS.get(name))
        if want is not None:
            if not torch.equal(t, torch.full_like(t, want)):
                raise SystemExit(f"phase 19 (a) {label}: {path} is not {want}")
            counts["constant"] += 1
            continue
        kind = "plain" if path in plain else "truncated"
        scale, kurt = (1.0, 3.0) if kind == "plain" else (P19_TRUNC["scale"],
                                                          P19_TRUNC["kurtosis"])
        n = t.numel()
        tol = max(P19_STD_RTOL, P19_STD_SIGMAS * math.sqrt((kurt - 1) / (4 * n)))
        err = abs(t.double().std().item() / (scale * P19_STD) - 1)
        worst[kind] = max(worst[kind], err)
        if err > tol:
            raise SystemExit(f"phase 19 (a) {label}: {path} std {t.std().item()} off "
                             f"{scale * P19_STD} by {err:.4f} > {tol:.4f} (n {n})")
        if kind == "truncated" and t.abs().max().item() > 2 * P19_STD:
            raise SystemExit(f"phase 19 (a) {label}: {path} max |x| {t.abs().max().item()} "
                             f"> 2 sigma")
        counts[kind] += 1
    return {"leaves": counts, "worst_std_rel_err": worst,
            "params": sum(t.numel() for _, t in named_leaves(tree))}


def p19_init(device, tok):
    """(a) init_pretrain_params at pretrain_video.yaml's model (ViT-B/16 224
    px, bert_config.json's MED widened to the tokenizer's 30524 ids, as the
    CLI does) and init_clip at ViT-L/14, fp32, CUDA generators;
    create_pretrain_state's own draw from the same seed equal bit for bit."""
    import dataclasses

    from vidil_tpu_torch.config import CLIPConfig, MedConfig, ViTConfig
    from vidil_tpu_torch.models.blip_pretrain import init_pretrain_params
    from vidil_tpu_torch.models.clip import init_clip
    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.train.pretrain import create_pretrain_state
    from vidil_tpu_torch.utils.seeding import init_generator

    vit_cfg = ViTConfig.from_name("base", 224, remat=True)
    repo = os.path.dirname(os.path.abspath(__file__))
    med_cfg = MedConfig.from_json(os.path.join(repo, "configs", "bert_config.json"),
                                  encoder_width=vit_cfg.hidden_size)
    med_cfg = dataclasses.replace(med_cfg, vocab_size=tok.vocab_size)
    out = {}
    torch.cuda.synchronize()
    t0 = time.time()
    params = init_pretrain_params(init_generator(0, device), vit_cfg, med_cfg, device=device)
    torch.cuda.synchronize()
    out["pretrain_init_s"] = time.time() - t0
    out["pretrain"] = p19_check_leaves("init_pretrain_params", params)
    state = create_pretrain_state(None, 1e-4, 0.05, vit_cfg=vit_cfg, med_cfg=med_cfg,
                                  queue_size=RET_QUEUE, seed=0, device=device)
    same = all(torch.equal(a, b.detach()) for (_, a), (_, b) in
               zip(named_leaves(params), named_leaves(state.params)))
    if not same:
        raise SystemExit("phase 19 (a): create_pretrain_state's draw is not the seed's tree")
    del params
    t0 = time.time()
    clip = init_clip(init_generator(0, device), CLIPConfig())
    torch.cuda.synchronize()
    out["clip_init_s"] = time.time() - t0
    out["clip"] = p19_check_leaves("init_clip", clip, P19_PLAIN)
    del clip
    torch.cuda.empty_cache()
    return state, vit_cfg, med_cfg, out


def p19_encode(fa, fvb, device):
    """(c), the encodes: ViT-B/384 from init_vit over a CapFilt chunk's 32
    frames (pixels a unit normal). The growth of a 1e-3 perturbation from 1
    block to 12 (fp32); then the encode through K1 (12 launches) against
    the one through its plain twin at the kernel's tiling, bf16 and fp32,
    and the bf16 encode on the fused-block schedule (K4, 12 launches)
    against the classic one."""
    import dataclasses

    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models import vit
    from vidil_tpu_torch.utils.seeding import init_generator

    cfg = ViTConfig.from_name("base", 384)
    ve = vit.init_vit(init_generator(1, device), cfg)
    gen = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((P19_FRAMES, 384, 384, 3), generator=gen, device=device)
    dx = 1e-3 * torch.randn(x.shape, generator=gen, device=device)
    mods = (fa, fvb)

    def twin(q, k, v, use_flash=True, grid=(1, 1)):
        return fa.flash_attention_ref(q, k, v, block_k=fa.KERNEL_BLOCK_K[q.dtype])

    launches = {}

    def encode(params, c, dtype, want, plain=False):
        orig = vit.attention_auto
        if plain:
            vit.attention_auto = twin
        _reset_counts(mods)
        try:
            with torch.no_grad():
                y = vit.vit_forward(params, x, c, dtype=dtype)
        finally:
            vit.attention_auto = orig
        launches[f"{c.use_fused_block}_{dtype}_{plain}"] = _p19_expect(
            "(c) encode", _read_counts(mods), want)
        if not torch.isfinite(y).all():
            raise SystemExit("phase 19 (c): non-finite encode")
        return y

    out = {"frames": P19_FRAMES}
    rel = {}
    for depth in (1, P19_LAYERS):
        part = dict(ve, blocks=ve["blocks"][:depth])
        with torch.no_grad():
            a = vit.vit_forward(part, x, cfg)
            b = vit.vit_forward(part, x + dx, cfg)
        rel[depth] = _rel_frob(b, a)
    growth = rel[P19_LAYERS] / rel[1]
    out["perturbation_rel_change"] = rel
    out["growth_1_to_12"] = growth
    k1 = {"flash_attention_fwd": P19_LAYERS}
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        got = encode(ve, cfg, dtype, k1)
        checks[f"k1_vs_twin_{name}"] = (_rel_frob(got, encode(ve, cfg, dtype, {}, plain=True)),
                                        dtype)
        if dtype == torch.bfloat16:
            fused = encode(ve, dataclasses.replace(cfg, use_fused_block=True), dtype,
                           {"fused_vit_block_fwd": P19_LAYERS})
            checks["k4_vs_classic_bf16"] = (_rel_frob(fused, got), dtype)
    out["launches"] = {"k1_bf16": launches[f"False_{torch.bfloat16}_False"],
                       "k1_fp32": launches[f"False_{torch.float32}_False"],
                       "k4_bf16": launches[f"True_{torch.bfloat16}_False"]}
    for name, (err, dtype) in checks.items():
        bar = P19_LAYERS * P19_UNIT[dtype] * max(1.0, growth)
        out[name] = {"rel_frobenius": err, "bar": bar}
        if not err <= bar:
            raise SystemExit(f"phase 19 (c) {name}: relative Frobenius {err} > bar {bar}")
    return out


def p19_grads(fa, fvb, state, vit_cfg, med_cfg, batch):
    """(c), the gradient: one fused pretraining step's loss and backward on
    the init (bf16, the trainers' schedule: 24 K4 + 12 K5) against the same
    with K4/K5 replaced by fused_block_ref / fused_block_bwd_ref, on the
    first run's negatives: the gathered ViT gradients' relative Frobenius
    distance (and the worst leaf's)."""
    from vidil_tpu_torch.models.blip_pretrain import pretrain_loss
    from vidil_tpu_torch.models.convert import named_leaves
    from vidil_tpu_torch.train.common import training_cfgs
    from vidil_tpu_torch.utils.seeding import make_generator

    vit_t, med_t = training_cfgs(vit_cfg, med_cfg)
    leaves = [p for _, p in named_leaves(state.params)]
    vit_leaves = named_leaves(state.params["visual_encoder"])
    negatives = None

    def grads():
        nonlocal negatives
        for p in leaves:
            p.grad = None
        ita, itm, lm, aux = pretrain_loss(
            state.params, state.params_m, state.queue, batch["video"], batch["text_ids"],
            batch["enc_ids"], batch["dec_ids"], batch["text_mask"], 0.4,
            make_generator(0, 0, state.device), vit_t, med_t, dtype=torch.bfloat16,
            negatives=negatives)
        (ita + itm + lm).backward()
        negatives = aux["negatives"]
        return {path: p.grad.detach().clone() for path, p in vit_leaves}

    _reset_counts((fa, fvb))
    got = grads()
    _p19_expect("(c) gradients", _read_counts((fa, fvb)),
                {"fused_vit_block_fwd": 2 * P19_LAYERS, "fused_vit_block_bwd": P19_LAYERS})
    launch_fwd, launch_bwd = fvb._launch_fwd, fvb._launch_bwd
    fvb._launch_fwd = lambda args, tl, nh, eps: fvb.fused_block_ref(
        *args, true_len=tl, num_heads=nh, eps=eps)
    fvb._launch_bwd = lambda args, g, tl, nh, eps: fvb.fused_block_bwd_ref(
        *args, g.to(args[0].dtype), true_len=tl, num_heads=nh, eps=eps)
    try:
        ref = grads()
    finally:
        fvb._launch_fwd, fvb._launch_bwd = launch_fwd, launch_bwd
    for p in leaves:
        p.grad = None
    flat = lambda g: torch.cat([t.reshape(-1).float() for t in g.values()])  # noqa: E731
    if not torch.isfinite(flat(got)).all():
        raise SystemExit("phase 19 (c) gradients: non-finite")
    worst = max(((_rel_frob(got[p], ref[p]), p) for p in ref if ref[p].norm() > 0))
    return {"rel_frobenius": _rel_frob(flat(got), flat(ref)), "worst_leaf": list(worst),
            "leaves": len(ref)}


def p19_caption_frames(fa, fvb, device, tok):
    """(d) CapFiltEngine.caption_frames over a chunk's 32 frames at 384 px
    (uint8 noise) through the init captioner (init_blip_decoder,
    BLIP-base/384, bf16, 3 beams, 20 tokens): 32 strings, exactly 12 K1
    launches (the encode; the decode's attention carries a bias), the same
    strings run to run; sample mode the same under one seed and other
    strings under another."""
    from vidil_tpu_torch.config import ViTConfig
    from vidil_tpu_torch.models.blip import init_blip_decoder
    from vidil_tpu_torch.utils.seeding import init_generator

    vit_cfg = ViTConfig.from_name("base", 384)
    med_cfg = _med_cfg(vit_cfg)
    cap = init_blip_decoder(init_generator(0, device), vit_cfg, med_cfg)
    # caption_frames reads no filterer
    engine = _engine(cap, {}, tok, vit_cfg, med_cfg, device)
    del cap
    gen = torch.Generator(device=device).manual_seed(23)
    frames = torch.randint(0, 256, (P19_FRAMES, 384, 384, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    mods = (fa, fvb)
    _reset_counts(mods)
    torch.cuda.synchronize()
    t0 = time.time()
    beam = engine.caption_frames(frames)
    beam_s = time.time() - t0
    launches = _p19_expect("(d) caption_frames", _read_counts(mods),
                           {"flash_attention_fwd": P19_LAYERS})
    if len(beam) != P19_FRAMES or not all(isinstance(c, str) for c in beam):
        raise SystemExit(f"phase 19 (d): {len(beam)} captions for {P19_FRAMES} frames")
    if engine.caption_frames(frames) != beam:
        raise SystemExit("phase 19 (d): beam captions differ run to run")
    sample = lambda seed: engine.caption_frames(  # noqa: E731
        frames, mode="sample", generator=torch.Generator(device=device).manual_seed(seed))
    s1 = sample(1)
    if sample(1) != s1 or sample(2) == s1:
        raise SystemExit("phase 19 (d): sampled captions not fixed by the seed")
    return {"captions": len(beam), "launches": launches, "beam_s": beam_s, "sample": beam[0],
            "sampled": s1[0],
            "distinct_beam_captions": len(set(beam))}


def run_phase19(fa, fvb, device, card, tok):
    """Phase 19: (a) the init on the card, (c) the full-depth checks on it,
    (b) pretraining from it, (d) caption_frames."""
    t_phase = time.time()
    out = {}
    state, vit_cfg, med_cfg, out["init"] = p19_init(device, tok)
    log(f"phase 19 (a): init_pretrain_params {out['init']['pretrain']['params']} parameters "
        f"in {out['init']['pretrain_init_s']:.3f} s, init_clip "
        f"{out['init']['clip']['params']} in {out['init']['clip_init_s']:.3f} s:",
        json.dumps(out["init"]))
    out["encode"] = p19_encode(fa, fvb, device)
    log("phase 19 (c) encodes:", json.dumps(out["encode"]))
    batch = _momentum_batch(tok, device, PRE_TOKENS, True)
    out["gradients"] = g = p19_grads(fa, fvb, state, vit_cfg, med_cfg, batch)
    bar = 2 * P19_LAYERS * P19_UNIT[torch.bfloat16] * max(1.0, out["encode"]["growth_1_to_12"])
    g["bar"] = bar
    log("phase 19 (c) gradients:", json.dumps(g))
    if not g["rel_frobenius"] <= bar:
        raise SystemExit(f"phase 19 (c) gradients: relative Frobenius {g['rel_frobenius']} > "
                         f"bar {bar}")

    from vidil_tpu_torch.train.pretrain import make_pretrain_step

    step = make_pretrain_step(vit_cfg, med_cfg, dtype=torch.bfloat16)
    want = {name: 0 for name in _counts(fa, fvb)}
    want.update(fused_vit_block_fwd=2 * P19_LAYERS, fused_vit_block_bwd=P19_LAYERS)
    _, t = momentum_loop("phase 19 (b) pretraining from the init", step, state, batch, fa, fvb,
                         want)
    del state
    first, last = t["losses"][0], t["losses"][-1]
    bars = p19_loss_bars(med_cfg.hidden_size, med_cfg.vocab_size)
    out["pretraining"] = {"losses": t["losses"], "bars": bars,
                          "steady_step_ms": t["steady_step_ms"], "step_ms": t["step_ms"],
                          "launches_per_step": t["launches_per_step"],
                          "peak_memory_gib": t["peak_memory_gib"]}
    for key in ("loss_itm", "loss_lm"):
        lo, hi = bars[key]
        if not lo <= first[key] <= hi:
            raise SystemExit(f"phase 19 (b): first step's {key} {first[key]} outside "
                             f"[{lo}, {hi}]")
    if not last["loss_lm"] < first["loss_lm"]:
        raise SystemExit(f"phase 19 (b): loss_lm {first['loss_lm']} -> {last['loss_lm']}")
    log(f"phase 19 (b): {RET_STEPS} pretraining steps from the init, first step loss_itm "
        f"{first['loss_itm']:.4f} in [{bars['loss_itm'][0]:.4f}, {bars['loss_itm'][1]:.4f}], "
        f"loss_lm {first['loss_lm']:.4f} in [{bars['loss_lm'][0]:.4f}, "
        f"{bars['loss_lm'][1]:.4f}] -> {last['loss_lm']:.4f}; median step "
        f"{t['steady_step_ms']:.2f} ms after the first; card {card}")
    torch.cuda.empty_cache()
    out["caption_frames"] = p19_caption_frames(fa, fvb, device, tok)
    log("phase 19 (d) caption_frames:", json.dumps(out["caption_frames"]))
    out["phase_s"] = time.time() - t_phase
    log(f"phase 19: {out['phase_s']:.1f} s; card {card}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the LM stage's grouped expert GEMM (K7)
# ---------------------------------------------------------------------------

# NVIDIA-Nemotron-3-Nano-30B-A3B's routed experts: 128 a layer, top 6, 2688
# <-> 1856, in 23 MoE layers; the LM cell's chunk: 16 prompts of 1500-3000
# tokens (36,000 tokens at their mean), 32 greedy tokens
K7_EXPERTS, K7_TOPK, K7_HIDDEN, K7_INTER, K7_MOE_LAYERS = 128, 6, 2688, 1856, 23
K7_TOKENS = {"prefill": 36000, "decode": 16}
K7_PER_PASS = 2 * K7_MOE_LAYERS
LM_PROMPTS, LM_NEW_TOKENS, LM_PROMPT_TOKENS = 16, 32, (1500, 3000)
# Kimi-Linear-48B-A3B-Instruct's on one card of a two-card expert-parallel
# deployment: 128 held of the router's 256, top 8, SwiGLU 2304 -> 2 x 1024
# (gate and up rows interleaved) and 1024 -> 2304, in 26 MoE layers; its
# cell's chunk has 36,400 tokens at the traffic's mean, about half of whose
# routed pairs go to the experts the other card holds
KIMI_HELD, KIMI_ROUTER, KIMI_TOPK, KIMI_HIDDEN, KIMI_INTER, KIMI_MOE_LAYERS = (
    128, 256, 8, 2304, 1024, 26)
KIMI_TOKENS = {"prefill": 36400, "decode": 16}
# (model, held experts, router experts, top k, hidden, expert width, up
# epilogue, tokens by shape, generator seed)
K7_MODELS = (("nemotron_h", K7_EXPERTS, K7_EXPERTS, K7_TOPK, K7_HIDDEN, K7_INTER, "relu2",
              K7_TOKENS, 20),
             ("kimi_linear", KIMI_HELD, KIMI_ROUTER, KIMI_TOPK, KIMI_HIDDEN, KIMI_INTER, "swiglu",
              KIMI_TOKENS, 21))


def k7_limit(want):
    """Kernel vs plain version: the same bf16 products summed in float32 in
    another order, which can flip the one bf16 rounding of an output: 2
    bf16 ulps of max|want|."""
    m = max(want.float().abs().max().item(), torch.finfo(torch.bfloat16).tiny)
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)


def k7_bound_ms(rows, experts_hit, N, K, n_out=None):
    """Least time of one K7 call: its 2 R N K operations at the bf16 peak,
    or its bytes at HBM's (rows in and `n_out` (N) columns out, each expert's
    weight hit once)."""
    n_out = N if n_out is None else n_out
    t_ops = 2.0 * rows * N * K / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = (2.0 * rows * (n_out + K) + 2.0 * experts_hit * N * K) / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_grouped_expert_gemm(k7, moe, device):
    """Phase 20 (a): K7 against its plain version at each LM's prefill and
    decode shapes, up and down (see the module's docstring)."""
    rows_out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's float32 sums
    try:
        for case in K7_MODELS:
            rows_out += k7_model_rows(k7, moe, device, *case)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows_out


def k7_model_rows(k7, moe, device, model, E, router, topk, D, I, act, tokens, seed):
    """One model's K7 rows: top `topk` of `router` random scores a token,
    the pairs of the E experts held sorted first (`moe.held_offsets`), the
    rest past offsets[E], which no launch reads or writes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_up = 2 * I if act == "swiglu" else I
    weights = {"up": torch.empty(E, n_up, D, device=device).normal_(0.0, 0.02, generator=gen)
               .to(torch.bfloat16),
               "down": torch.empty(E, D, I, device=device).normal_(0.0, 0.02, generator=gen)
               .to(torch.bfloat16)}
    rows_out = []
    for label, T in tokens.items():
        idx = torch.rand(T, router, generator=gen, device=device).topk(topk, dim=-1).indices
        _, offsets = moe.held_offsets(idx, 0, E)
        bounds = offsets.tolist()
        R, held = T * topk, bounds[E]
        hit = sum(hi > lo for lo, hi in zip(bounds, bounds[1:]))
        for name, epilogue in (("up", act), ("down", "store")):
            w = weights[name]
            N, K = w.shape[1], w.shape[2]
            n_out = N // 2 if epilogue == "swiglu" else N
            x = torch.randn(R, K, generator=gen, device=device).to(torch.bfloat16)
            got = k7.grouped_expert_gemm(x, w, offsets, epilogue)[:held]
            again = k7.grouped_expert_gemm(x, w, offsets, epilogue)[:held]
            torch.cuda.synchronize()
            want = k7.grouped_expert_gemm_ref(x, w, offsets, epilogue)[:held]
            err = (got.float() - want.float()).abs().max().item()
            limit = k7_limit(want)
            bitwise = torch.equal(got, again)
            del want, again

            def kernel():
                return k7.grouped_expert_gemm(x, w, offsets, epilogue)

            def library():
                out = torch.empty(R, n_out, dtype=x.dtype, device=device)
                for e in range(E):
                    lo, hi = bounds[e], bounds[e + 1]
                    if hi > lo:
                        h = F.linear(x[lo:hi], w[e])
                        if epilogue == "relu2":
                            h = torch.relu(h).square()
                        elif epilogue == "swiglu":
                            h = k7.silu_gate(h)
                        out[lo:hi] = h
                return out

            bound, bound_by = k7_bound_ms(held, hit, N, K, n_out)
            dev_ms, kernels = device_profile(kernel)
            row = dict(model=model, shape=label, projection=name, epilogue=epilogue,
                       dtype="bfloat16", rows=R, held_rows=held, experts_hit=hit, n=N, k=K,
                       n_out=n_out, max_abs_err=err, limit=limit, run_to_run_bitwise=bitwise,
                       ms=time_ms(kernel), device_ms=dev_ms, bound_ms=bound, bound_by=bound_by,
                       bound_share=bound / dev_ms, tflops=2.0 * held * N * K / dev_ms / 1e9,
                       library_ms=time_ms(library),
                       kernels={k.split("(")[0]: v for k, v in kernels.items()})
            log("kernel check (grouped expert GEMM K7):", json.dumps(row))
            rows_out.append(row)
            if not (bool(torch.isfinite(got).all()) and bitwise and err <= limit
                    and got.shape == (held, n_out)):
                raise SystemExit(f"grouped_expert_gemm disagrees with its plain version: "
                                 f"{row}")
            del x, got
    del weights
    torch.cuda.empty_cache()
    return rows_out


# K8: one launch a Mamba layer of the prefill (23 of 52 layers), at the
# cell's widths
K8_MAMBA_LAYERS, K8_H, K8_P, K8_G, K8_N, K8_CHUNK = 23, 64, 64, 8, 128, 128


def k8_bound_ms(lengths):
    """Least time of one K8 call on the packing `lengths`: its bytes (x, B,
    C in bf16 and dt read, y in float32 and the final states written) at
    HBM's rate, or the products its inputs need at three bf16 terms each
    (C.B^T's causal half once, the causal half of the intra-chunk product,
    the read-out from the entering state and the chunk state three times)
    at the bf16 peak."""
    H, P, G, N, L = K8_H, K8_P, K8_G, K8_N, K8_CHUNK
    T = sum(lengths)
    chunks = sum(-(-n // L) for n in lengths)
    nbytes = T * (2 * (H * P + 2 * G * N) + 4 * H + 4 * H * P) + 4 * len(lengths) * H * P * N
    flops = 2.0 * chunks * H * (L * L * N / 2 + 3 * L * L * P / 2 + 6 * L * N * P)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ssd_scan(ssd, device):
    """Phase 20 (c): K8 against its plain version at one Mamba layer of a
    benchmark chunk's packing (see the module's docstring)."""
    H, P, G, N, L = K8_H, K8_P, K8_G, K8_N, K8_CHUNK
    rng = np.random.default_rng(20)
    lengths = [int(n) for n in rng.integers(LM_PROMPT_TOKENS[0], LM_PROMPT_TOKENS[1] + 1,
                                            LM_PROMPTS)]
    T = sum(lengths)
    gen = torch.Generator(device=device).manual_seed(20)
    xbc = torch.randn(T, H * P + 2 * G * N, generator=gen, device=device).to(torch.bfloat16)
    x = xbc[:, :H * P].reshape(T, H, P)
    B = xbc[:, H * P:H * P + G * N].reshape(T, G, N)
    C = xbc[:, H * P + G * N:].reshape(T, G, N)
    dt0 = torch.exp(torch.empty(H, device=device).uniform_(math.log(1e-3), math.log(0.1),
                                                            generator=gen))
    dt = F.softplus(torch.randn(T, H, generator=gen, device=device) * 0.5
                    + dt0 + torch.log(-torch.expm1(-dt0)))
    A = -torch.empty(H, device=device).uniform_(1.0, 16.0, generator=gen)
    D = torch.ones(H, device=device)
    packed = ssd.pack(ssd.Packing(tuple(lengths)), L, device)
    args = (x, dt, A, B, C, D, packed.layout, len(lengths), L)
    before = ssd.launch_counts["ssd_scan"]
    y, final = ssd.ssd_chunked(*args)
    y2, final2 = ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    launches = ssd.launch_counts["ssd_scan"] - before
    want_y, want_final = ssd.ssd_chunked_ref(*args)
    # twice tests/test_torch_ssd_scan.py's float32 limit (gamma_n of max|want|)
    n = 2 * N + L + 8 + -(-max(lengths) // L) * (L + 4)
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    errs = {name: (got - want).abs().max().item()
            for name, got, want in (("y", y, want_y), ("final", final, want_final))}
    limits = {"y": 2 * gamma * want_y.abs().max().item(),
              "final": 2 * gamma * want_final.abs().max().item()}
    bitwise = torch.equal(y, y2) and torch.equal(final, final2)
    finite = bool(torch.isfinite(y).all() and torch.isfinite(final).all())
    del y2, final2, want_y, want_final

    def kernel():
        return ssd.ssd_chunked(*args)

    def plain():
        return ssd.ssd_chunked_ref(*args)

    bound, bound_by = k8_bound_ms(lengths)
    dev_ms, kernels = device_profile(kernel)
    row = dict(shape="lm_prefill_layer", dtype="bfloat16 x, B, C; float32 scan", tokens=T,
               prompts=len(lengths), chunks=sum(-(-n_ // L) for n_ in lengths),
               max_abs_err=errs, limit=limits, run_to_run_bitwise=bitwise,
               launches_per_call=launches / 2, ms=time_ms(kernel), device_ms=dev_ms,
               bound_ms=bound, bound_by=bound_by, bound_share=bound / dev_ms,
               plain_ms=time_ms(plain), launches_per_prefill=K8_MAMBA_LAYERS * launches // 2,
               kernels={k.replace("(anonymous namespace)::", "").split("(")[0]: v
                        for k, v in kernels.items()})
    log("kernel check (chunked SSD scan K8):", json.dumps(row))
    if not (finite and bitwise and launches == 2 and all(errs[k] <= limits[k] for k in errs)
            and all("ssd_scan" in k for k in kernels)):
        raise SystemExit(f"ssd_scan disagrees with its plain version: {row}")
    del x, B, C, xbc, dt, y, final, args
    torch.cuda.empty_cache()
    return row


def lm_prompts(tok_words, n_chunks, seed=20):
    """n_chunks chunks of LM_PROMPTS prompts of random words, each of a
    length drawn from LM_PROMPT_TOKENS (its <s> included)."""
    rng = np.random.default_rng(seed)
    lo, hi = LM_PROMPT_TOKENS
    return [[" ".join(rng.choice(tok_words, int(rng.integers(lo, hi + 1)) - 1))
             for _ in range(LM_PROMPTS)] for _ in range(n_chunks)]


def run_lm_engine(k7, device, model):
    """Phase 20 (b): K7's and K8's launches a chunk from the LM stage's own
    run of `model` (eager, capture, replays), and one replayed chunk under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vidil_tpu_torch.config import KimiLinearConfig, NemotronHConfig
    from vidil_tpu_torch.ops import ssd
    from vidil_tpu_torch.pipeline.lm_answer import (MODELS, SPECIALS, LMAnswerEngine,
                                                    WordTokenizer)

    if model == "nemotron_h":
        cfg, moe_layers = NemotronHConfig(), K7_MOE_LAYERS
        found = cfg.hybrid_override_pattern.count("E")
    else:  # the card's share of the two-card deployment
        cfg = KimiLinearConfig(num_experts=KIMI_HELD, num_experts_published=KIMI_ROUTER)
        moe_layers = KIMI_MOE_LAYERS
        found = cfg.num_hidden_layers - cfg.first_k_dense_replace
    if found != moe_layers:
        raise SystemExit(f"{model}: {found} MoE layers, want {moe_layers}")
    per_pass = 2 * moe_layers
    t0 = time.time()
    params = MODELS[cfg.model_type][1](cfg, torch.Generator(device=device).manual_seed(20),
                                       device)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    words = [f"w{i}" for i in range(20000)]
    tok = WordTokenizer(SPECIALS + words)
    engine = LMAnswerEngine(params, cfg, tok, max_prompt_tokens=LM_PROMPT_TOKENS[1],
                            max_new_tokens=LM_NEW_TOKENS, device=device)
    chunks = lm_prompts(words, 5)
    steps = LM_NEW_TOKENS - 1
    want = [per_pass * (1 + steps), per_pass * (1 + 2 * steps), per_pass, per_pass]
    per_chunk, k8_per_chunk, chunk_ms, answers = [], [], [], []
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        for chunk in chunks[:4]:
            k7.launch_counts["grouped_expert_gemm"] = 0
            k8_before = ssd.launch_counts["ssd_scan"]
            t0 = time.perf_counter()
            answers = engine.complete_chunk(engine.dispatch_chunk(chunk))
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            per_chunk.append(k7.launch_counts["grouped_expert_gemm"])
            k8_per_chunk.append(ssd.launch_counts["ssd_scan"] - k8_before)
        k7.launch_counts["grouped_expert_gemm"] = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.complete_chunk(engine.dispatch_chunk(chunks[4]))
            torch.cuda.synchronize()
    profiled = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "grouped_gemm_bf16" in e.key)
    out = {"model": model, "moe_layers": moe_layers, "init_s": init_s,
           "launches_by_chunk": per_chunk, "want": want, "k8_launches_by_chunk": k8_per_chunk,
           "chunk_ms": chunk_ms, "replayed_chunk_wrapper_launches":
           k7.launch_counts["grouped_expert_gemm"], "replayed_chunk_profiled_kernels": profiled,
           "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "answers": len(answers), "sample_answer": answers[0][:80]}
    del engine, params
    torch.cuda.empty_cache()
    return out


def run_phase20(device, card):
    """Phase 20: K7 alone at the LM cell's shapes, then its launches in the
    LM stage's own run (see the module's docstring)."""
    from vidil_tpu_torch.ops import grouped_expert_gemm as k7
    from vidil_tpu_torch.ops import moe, ssd

    t_phase = time.time()
    out = {"kernel": check_grouped_expert_gemm(k7, moe, device),
           "k8": check_ssd_scan(ssd, device)}
    # K8 runs in Nemotron-H's Mamba layers only, one launch each a prefill
    for model, k8_launches in (("nemotron_h", K8_MAMBA_LAYERS), ("kimi_linear", 0)):
        out[f"engine_{model}"] = e = run_lm_engine(k7, device, model)
        log(f"phase 20 (b) LMAnswerEngine {model}:", json.dumps(e))
        per_pass = 2 * e["moe_layers"]
        full = per_pass * LM_NEW_TOKENS
        if e["launches_by_chunk"] != e["want"]:
            raise SystemExit(f"{model}: K7 launches by chunk {e['launches_by_chunk']}, want "
                             f"{e['want']}")
        if e["k8_launches_by_chunk"] != [k8_launches] * len(e["k8_launches_by_chunk"]):
            raise SystemExit(f"{model}: K8 launches by chunk {e['k8_launches_by_chunk']}, want "
                             f"{k8_launches} each")
        if not (e["replayed_chunk_wrapper_launches"] == per_pass
                and (1 - PROFILE_LOSS) * full <= e["replayed_chunk_profiled_kernels"] <= full):
            raise SystemExit(f"{model}: K7 in a replayed chunk: {e}, want {full} kernels")
        if e["answers"] != LM_PROMPTS:
            raise SystemExit(f"{model}: {e['answers']} answers for {LM_PROMPTS} prompts")
    out["phase_s"] = time.time() - t_phase
    log(f"phase 20: {out['phase_s']:.1f} s; card {card}")
    return out


def main_phase20():
    """`--phase20`: build K7 and K8 and run phase 20 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from vidil_tpu_torch.ops import _build

    card = card_line()
    log("card:", card)
    t0 = time.time()
    _build.build_all(["grouped_expert_gemm", "ssd_chunk_scan"])
    log(f"build: {time.time() - t0:.1f} s")
    out = run_phase20(torch.device("cuda"), card)
    print(json.dumps({"phase20": out}), flush=True)
    return 0


def main_p18_world(world):
    """`--phase18-world N`: phase 18 (a) over N NCCL ranks, one GPU each, a
    (N / 2) x 2 grid (needs N cards)."""
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --phase18-world {world} needs {world} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    from vidil_tpu_torch.ops import _build

    card = card_line()
    log("cards:", world, "x", card)
    t0 = time.time()
    _build.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        out = p18_tensor_parallel(torch.device("cuda", 0), root, world, "nccl")
    log(f"phase 18 (a) over {world} NCCL ranks: ranks {out['ranks_s']:.1f} s; cards "
        f"{world} x {card}")
    return 0


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
    from vidil_tpu_torch.ops import decode_attention as da
    from vidil_tpu_torch.ops import flash_attention as fa
    from vidil_tpu_torch.ops import fused_mlp as fm
    from vidil_tpu_torch.ops import fused_vit_block as fvb

    t0 = time.time()
    libs = _build.build_all()
    log(f"build: {time.time() - t0:.1f} s for {len(libs)} libraries, nvcc in parallel")
    for name, path in libs.items():
        log(f"ptxas ({name}):", " | ".join(sorted(set(
            line.strip() for line in open(f"{path}.log") if "registers" in line or "spill" in line))))
    sass = check_sass(libs)

    tok = bench_tokenizer()
    texts, rerank_len = retrieval_corpus(tok)  # phase 15's corpus, for phase 3's shape
    rows = check_flash_kernel(fa, device, rerank_len)
    k6_rows = check_decode_attention(da, device)

    t0 = time.time()
    engine, vit_cfg, med_cfg = make_engine(device)
    torch.cuda.synchronize()
    log(f"engine: synthetic full-width weights on the device in {time.time() - t0:.1f} s")
    chunks = make_chunks(yuv_chunks={2, 4})
    # K1 in the two encodes' self-attention (32 frames x 577 tokens); the
    # reference's gate keeps the ITM's attention on the plain path: the fused
    # filter's 96-row fold (Lq < 128) and a classic filter call's (at most 32
    # frames x 140 rows over 577 keys: 124 MB of logits, under 128 MiB)
    per_chunk = 2 * vit_cfg.num_layers
    results, launches, k6_launches, classic_calls, fps, peak = run_main_path(
        engine, fa, da, chunks, per_chunk)
    want = per_chunk * len(chunks)
    if launches != want:
        raise SystemExit(f"kernel launches {launches}, want {want}")
    # chunk 0 eager, chunk 1 its capture (an eager pass, then the captured
    # one), then replays
    k6_want = [K6_PER_DECODE, 2 * K6_PER_DECODE] + [0] * (len(chunks) - 2)
    if k6_launches != k6_want:
        raise SystemExit(f"K6 launches by chunk {k6_launches}, want {k6_want}")
    k6_replay = profile_k6_chunk(engine, da, chunks[1])
    log("main path: one replayed chunk under torch.profiler:", json.dumps(k6_replay))
    if not (k6_replay["wrapper_launches"] == 0 and (1 - PROFILE_LOSS) * K6_PER_DECODE
            <= k6_replay["profiled_kernels"] <= K6_PER_DECODE):
        raise SystemExit(f"K6 in a replayed chunk: {k6_replay}, want {K6_PER_DECODE} kernels")
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

    frames0 = _concat_frames([c["frames"] for c in chunks[0]])
    situ = in_situ_check(engine, fa, frames0, vit_cfg, med_cfg)
    log("in-situ (kernel vs twin in the captioner encode):", json.dumps(situ))
    situ_enc = in_situ_fused_encode(engine, frames0, vit_cfg, "use_fused_block",
                                    fvb.launch_counts, "fused_vit_block_fwd")
    log("in-situ (fused-block K4 vs classic captioner encode, 384 px):", json.dumps(situ_enc))
    situ_mlp = in_situ_fused_encode(engine, frames0, vit_cfg, "use_fused_mlp",
                                    fm.launch_counts, "fused_mlp_fwd")
    log("in-situ (fused MLP K3 vs plain MLP, captioner encode, 384 px):", json.dumps(situ_mlp))

    del engine
    torch.cuda.empty_cache()
    lse_rows = check_fwd_lse(fa, device)
    bwd_rows = check_bwd(fa, device)
    block_fwd_rows, block_bwd_rows = check_fused_block(fvb, device)
    attn_rows = check_block_attention(fvb, device)
    attn_bwd_rows = check_block_attention_bwd(fvb, device)

    trains = {}
    for schedule, steps in (("classic", CLASSIC_STEPS), ("fused", TRAIN_STEPS)):
        t = trains[schedule] = run_caption_training(fa, fvb, device, schedule, steps)
        log(f"training ({schedule}): steady step {t['steady_step_ms']:.2f} ms (CUDA events, "
            f"step 1 excluded; host enqueue {t['steady_enqueue_ms']:.2f} ms), "
            f"{t['samples_per_s']:.2f} samples/s ({TRAIN_VIDEOS} videos x {TRAIN_FRAMES} "
            f"frames), peak memory {t['peak_memory_gib']:.2f} GiB, card {card}")
        log(f"training ({schedule}):", json.dumps(t))
        prof = t["profile"]
        log(f"training profile ({schedule}, one step, torch.profiler): kernels "
            f"{prof['device_ms']:.2f} ms on the device, {prof['device_busy_share']:.3f} of the "
            f"steady step; flash kernels {prof['flash_kernels_ms']:.2f} ms; fused-block kernels "
            f"{prof['fused_block_kernels_ms']:.2f} ms; {prof['kernel_launches']} kernel launches")
    vqa = run_vqa(fa, fvb, device)
    log(f"vqa training: steady step {vqa['steady_step_ms']:.2f} ms (host enqueue "
        f"{vqa['steady_enqueue_ms']:.2f} ms), {vqa['samples_per_s']:.2f} questions/s, peak "
        f"memory {vqa['peak_memory_gib']:.2f} GiB; generate {vqa['generate_s']:.3f} s, rank "
        f"{vqa['rank_s']:.3f} s; card {card}")
    log("vqa:", json.dumps(vqa))
    situ_bwd, situ_launches = in_situ_backward(fa, device)
    log("in-situ (kernels vs twins, one ViT block's gradients, bf16):", json.dumps(situ_bwd))
    situ_block = in_situ_fused_block(fvb, device)
    log("in-situ (K4/K5 vs twins, one fused ViT block's gradients, bf16):",
        json.dumps(situ_block))
    mlp_rows = check_fused_mlp(fm, device)
    vt = run_visual_tokenization(fa, fm, device)
    for name, r in vt.items():
        log(f"visual tokenization ({name}): {r['frames_per_s']:.2f} frames/s ({VT_VIDEOS} videos "
            f"x {VT_FRAMES} frames, second chunk), ontology embedding "
            f"{r['ontology_embedding_s']:.2f} s, rerank {r['rerank_s']:.3f} s, peak memory "
            f"{r['peak_memory_gib']:.2f} GiB, card {card}")
    sb = run_prompt_side(fa, fm, fvb, device, card)
    log(f"prompt side (SBERT all-mpnet-base-v2, bf16): caption selection "
        f"{sb['caption_selection_ms_per_query']:.3f} ms/query ({sb['caption_queries_per_s']:.1f} "
        f"queries/s), QA selection {sb['qa_selection_ms_per_query']:.3f} ms/query "
        f"({sb['qa_queries_per_s']:.1f} queries/s), single-sentence encode "
        f"{sb['single']['ms']:.3f} ms (host enqueue {sb['single']['host_enqueue_ms']:.3f} ms, "
        f"device {sb['single']['device_ms']:.4f} ms, {sb['single']['launches']} launches); "
        f"64 x 128 batch {sb['batch']['ms']:.3f} ms ({sb['batch']['sentences_per_s']:.0f} "
        f"sentences/s; device {sb['batch']['device_ms']:.3f} ms, {sb['batch']['launches']} "
        f"launches); answer mapping {sb['answer_mapping_s']:.2f} s, VLEP "
        f"{sb['vlep_s']:.2f} s; peak memory {sb['peak_memory_gib']:.2f} GiB; phase "
        f"{sb['phase_s']:.1f} s; card {card}")
    log("prompt side:", json.dumps(sb))
    ret = run_retrieval_phase(fa, fvb, device, card, tok, texts, rerank_len)
    del texts
    p16 = run_phase16(fa, fm, fvb, device, card, tok)
    smp, ds = p16["sampling"], p16["decode_structure"]
    log(f"phase 16 (CapFilt modes, bf16, {N_VIDEOS} videos x {N_FRAMES} frames a chunk): "
        f"sample decode {smp['sample_decode_s']:.3f} s a chunk (enqueue "
        f"{smp['sample_decode_enqueue_s']:.3f}) beside the beam decode's "
        f"{smp['beam_decode_s']:.3f} ({smp['beam_decode_enqueue_s']:.3f}); unroll "
        f"{ds['unroll']['decode_s']:.3f} s, lazy {ds['lazy']['decode_s']:.3f} s, both "
        f"{ds['both']['decode_s']:.3f} s (fp32 token-identical; bf16 agreement "
        f"{ds['unroll']['token_agreement_bf16']:.3f} / {ds['lazy']['token_agreement_bf16']:.3f}"
        f" / {ds['both']['token_agreement_bf16']:.3f}); phase {p16['phase_s']:.1f} s; "
        f"card {card}")
    for name, r in p16["resize_on_device"].items():
        log(f"phase 16 resize_on_device {name}: {r['card_vs_cpu_tie_flips']} tie flips of "
            f"{r['card_vs_cpu_pixels']} against the CPU; against PIL max "
            f"{r['vs_pil_max_levels']:.0f} levels, share {r['vs_pil_differing_share']:.4f}; "
            f"encode {r['encode_native_s']:.4f} s native, {r['encode_host_resized_s']:.4f} s "
            f"host-resized (+ {r['pil_resize_host_s']:.3f} s PIL)")

    p17 = run_phase17(fa, device, card, tok)
    p18 = run_phase18(fa, fvb, device, card)
    p19 = run_phase19(fa, fvb, device, card, tok)
    torch.cuda.empty_cache()
    p20 = run_phase20(device, card)
    p18_ranks = p18["tensor_parallel"]["classic"]["ranks"]
    p18_fused_ranks = p18["tensor_parallel"]["fused"]["ranks"]

    def tp_row(rs):
        """A K1/K2 bf16 check row at a tensor-parallel rank's shape."""
        r = next(x for x in rs if x["dtype"] == "bfloat16" and x["shape"] == TP_SHAPE[0]
                 and x.get("layout", "views") == "views")
        return {k: r[k] for k in ("q", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                  "max_abs_err", "run_to_run_bitwise") if k in r}

    def entry(name, source, replaces, n, rs, shape, desc, **extra):
        r = next(x for x in rs if x["dtype"] == "bfloat16" and x.get("layout", "views") == "views"
                 and x["shape"] == shape)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n,
                "max_abs_err": max(x["max_abs_err"] for x in rs if x["dtype"] == "bfloat16"),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": desc,
                **{k: r[k] for k in RATE_KEYS if k in r}, **extra}

    def gemm_sass(lib):
        """A library's bf16 GEMM instances and their fewest wgmma and TMA
        instructions (phase 2 fails if any is 0)."""
        return {"instances": len(sass[lib]),
                "min_HGMMA": min(c["HGMMA"] for c in sass[lib].values()),
                "min_UTMALDG": min(c["UTMALDG"] for c in sass[lib].values())}

    def device(rs, shape, keys=("device_ms", "library_device_ms", "gemm_tflops")):
        r = next(x for x in rs if x["dtype"] == "bfloat16" and x["shape"] == shape)
        return {k: r[k] for k in keys}

    def attention_bwd():
        """K5's bf16 attention backward alone at both block shapes."""
        keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms",
                "bound_by", "tflops_5_products", "tflops_9_products", "max_abs_err", "rel_errs")
        return {r["shape"]: {k: r[k] for k in keys} for r in attn_bwd_rows
                if r["dtype"] == "bfloat16"}

    def attention(stats):
        """The bf16 block attention launch alone at the trainer block."""
        r = next(x for x in attn_rows if x["dtype"] == "bfloat16" and x["shape"] == "train_224"
                 and x["stats"] == stats)
        return {k: r[k] for k in ("ms", "device_ms", "library_ms", "library_device_ms",
                                  "bound_ms", "max_abs_err")}

    fwd_src = "vidil_tpu_torch/csrc/flash_attention_fwd.cu"
    fused = trains["fused"]["launches"]
    record = {"kernels": [
        entry("flash_attention_fwd", fwd_src, "vidil_tpu/ops/flash_attention.py:290", launches,
              rows, "vit_self_attention",
              "q,k,v (32, 12, 577, 64) bf16 views of the QKV projection; CapFilt path",
              launches_visual_tokenization_blip=vt["blip"]["launches"]["flash_attention_fwd"],
              launches_visual_tokenization_clip=vt["clip"]["launches"]["flash_attention_fwd"],
              launches_retrieval_eval=ret["eval"]["launches"]["flash_attention_fwd"],
              launches_phase16=dict(
                  sampling_per_chunk=p16["sampling"]["k1_per_chunk"],
                  resize_on_device_per_chunk=[r["k1_per_chunk"] for r in
                                              p16["resize_on_device"].values()],
                  decode_structure_per_chunk=[p16["decode_structure"][m]["k1_per_chunk"]
                                              for m in ("unroll", "lazy", "both")],
                  nlvr_forward=p16["models"]["nlvr"]["k1"],
                  embedding_itm=p16["models"]["embedding_itm"]["k1"], return_attn=0),
              launches_phase17=dict(
                  capfilt_cli_per_rank=[r["capfilt"]["launches"]["flash_attention_fwd"]
                                        for r in p17["two_ranks"]["ranks"]],
                  sharded_rerank_per_rank=[r["rerank"]["launches"]["flash_attention_fwd"]
                                           for r in p17["two_ranks"]["ranks"]],
                  use_flash_false_encode=p17["use_flash"]["use_flash_false"]["k1"]),
              launches_phase19=dict(
                  init_encode=p19["encode"]["launches"]["k1_bf16"]["flash_attention_fwd"],
                  caption_frames=p19["caption_frames"]["launches"]["flash_attention_fwd"]),
              device_ms_vit_views=next(
                  x["device_ms"] for x in rows if x["shape"] == "vit_self_attention"
                  and x["layout"] == "views" and x["dtype"] == "bfloat16"),
              library_device_ms_vit_views=next(
                  x["library_device_ms"] for x in rows if x["shape"] == "vit_self_attention"
                  and x["layout"] == "views" and x["dtype"] == "bfloat16"),
              retrieval_rerank_fold=dict(
                  dispatch_device_ms=ret["eval"]["k1_fold_dispatch_device_ms"],
                  back_to_back_ms=ret["eval"]["k1_fold_back_to_back_ms"],
                  library_back_to_back_ms=ret["eval"]["sdpa_fold_back_to_back_ms"],
                  **{k: next(x for x in rows if x["shape"] == "retrieval_rerank_fold"
                             and x["dtype"] == "bfloat16" and x["layout"] == "views")[k]
                     for k in ("q", "kv", "ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "max_abs_err")}),
              sass=sass["flash_attention_fwd"]),
        entry("flash_attention_fwd_lse", fwd_src, "vidil_tpu/ops/flash_attention.py:290",
              situ_launches["flash_attention_fwd_lse"], lse_rows, "vit_self_attention",
              "q,k,v (32, 12, 577, 64) bf16 views, with fp32 lse rows; the classic schedule's "
              "ViT-B/384 block (phase 11); at 224 px the reference's gate sends the attention "
              "to the plain path",
              launches_phase18_tensor_parallel_per_rank_per_step=[
                  [c["flash_attention_fwd_lse"] for c in r["launches"]] for r in p18_ranks],
              tensor_parallel_rank=tp_row(lse_rows)),
        entry("flash_attention_bwd", "vidil_tpu_torch/csrc/flash_attention_bwd.cu",
              "vidil_tpu/ops/flash_attention.py:242", situ_launches["flash_attention_bwd"],
              bwd_rows, "train_384",
              "q,k,v,o,g (32, 12, 577, 64) bf16 views; the classic schedule's ViT-B/384 block "
              "(phase 11)",
              **device(bwd_rows, "train_384", ("device_ms", "library_device_ms",
                                               "tflops_7_products", "tflops_5_products")),
              launches_phase18_tensor_parallel_per_rank_per_step=[
                  [c["flash_attention_bwd"] for c in r["launches"]] for r in p18_ranks],
              tensor_parallel_rank=tp_row(bwd_rows),
              sass={k: v for k, v in sass.items() if k.startswith("flash_attention_bwd:")}),
        entry("fused_vit_block_fwd", "vidil_tpu_torch/csrc/fused_vit_block_fwd.cu",
              "vidil_tpu/ops/fused_vit_block.py:139", fused["fused_vit_block_fwd"],
              block_fwd_rows, "train_224",
              "x (48, 256, 768) bf16, 197 true tokens, ViT-B/16 block; fused caption training "
              "path (the trainers' default)",
              launches_vqa=vqa["launches"]["fused_vit_block_fwd"],
              launches_pretrain_step=ret["pretraining"]["launches_per_step"]["fused_vit_block_fwd"],
              launches_phase17_caption_step_per_rank=[
                  r["caption"]["launches"]["fused_vit_block_fwd"]
                  for r in p17["two_ranks"]["ranks"]],
              launches_phase17_nccl_world_of_one=p17["nccl_world_of_one"]["all_reduce"][
                  "launches"]["fused_vit_block_fwd"],
              launches_phase18_tensor_parallel_per_rank_per_step=[
                  [c["fused_vit_block_fwd"] for c in r["launches"]] for r in p18_fused_ranks],
              launches_phase19_pretrain_step_from_init=p19["pretraining"]["launches_per_step"][
                  "fused_vit_block_fwd"],
              **device(block_fwd_rows, "train_224"), sass_gemm=gemm_sass("fused_vit_block_fwd"),
              attention=attention(False), attention_with_stats=attention(True),
              sass_attention=sass["fused_vit_block_fwd:attn_fwd_wgmma"]),
        entry("fused_vit_block_bwd", "vidil_tpu_torch/csrc/fused_vit_block_bwd.cu",
              "vidil_tpu/ops/fused_vit_block.py:345", fused["fused_vit_block_bwd"],
              block_bwd_rows, "train_224",
              "x, g (48, 256, 768) bf16, 197 true tokens, ViT-B/16 block; fused caption training "
              "path (the trainers' default)",
              launches_vqa=vqa["launches"]["fused_vit_block_bwd"],
              launches_pretrain_step=ret["pretraining"]["launches_per_step"]["fused_vit_block_bwd"],
              launches_phase17_caption_step_per_rank=[
                  r["caption"]["launches"]["fused_vit_block_bwd"]
                  for r in p17["two_ranks"]["ranks"]],
              launches_phase17_nccl_world_of_one=p17["nccl_world_of_one"]["all_reduce"][
                  "launches"]["fused_vit_block_bwd"],
              launches_phase18_tensor_parallel_per_rank_per_step=[
                  [c["fused_vit_block_bwd"] for c in r["launches"]] for r in p18_fused_ranks],
              launches_phase19_pretrain_step_from_init=p19["pretraining"]["launches_per_step"][
                  "fused_vit_block_bwd"],
              **device(block_bwd_rows, "train_224"), sass_gemm=gemm_sass("fused_vit_block_bwd"),
              parts=device(block_bwd_rows, "train_224", ("parts",))["parts"],
              capfilt_384=device(block_bwd_rows, "capfilt_384",
                                 ("ms", "device_ms", "library_device_ms", "parts")),
              workspace_bytes={r["shape"]: r["workspace_bytes"] for r in block_bwd_rows
                               if r["dtype"] == "bfloat16"},
              attention_bwd=attention_bwd(),
              sass_attention={k: v for k, v in sass.items()
                              if k.startswith("fused_vit_block_bwd:attn_")}),
        entry("fused_mlp_fwd", "vidil_tpu_torch/csrc/fused_mlp_fwd.cu",
              "vidil_tpu/ops/fused_mlp.py:69", vt["blip"]["launches"]["fused_mlp_fwd"],
              mlp_rows, "vit_encode",
              "x (36928, 768) -> 3072 bf16, the ViT-B/384 encode of a chunk (8 videos x 8 "
              "frames); visual tokenization path (BLIP engine, use_fused_mlp)",
              launches_ontology=vt["blip"]["ontology_launches"]["fused_mlp_fwd"],
              **device(mlp_rows, "vit_encode"), sass_gemm=gemm_sass("fused_mlp_fwd")),
        entry("decode_cross_attention", "vidil_tpu_torch/csrc/decode_cross_attention.cu",
              "none: the decode's cross-attention at 2 FLOP/byte",
              k6_launches[0], k6_rows, "beam_step",
              "q (96, 1, 768) over k, v (32, 12, 577, 64) bf16 views of the precomputed memory; "
              "the CapFilt beam decode's step (prefill: q (96, 4, 768)); launches: the main "
              "path's eager first chunk",
              launches_main_path_by_chunk=k6_launches,
              profiled_kernels_replayed_chunk=k6_replay["profiled_kernels"],
              device_ms=next(r["device_ms"] for r in k6_rows if r["dtype"] == "bfloat16"
                             and r["shape"] == "beam_step"),
              prefill={k: next(r for r in k6_rows if r["dtype"] == "bfloat16"
                               and r["shape"] == "beam_prefill")[k]
                       for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}),
    ]}
    k7_prefill = next(r for r in p20["kernel"] if r["model"] == "nemotron_h"
                      and r["shape"] == "prefill" and r["projection"] == "up")
    nem, kimi = p20["engine_nemotron_h"], p20["engine_kimi_linear"]
    record["kernels"].append(dict(
        name="grouped_expert_gemm", route="cuda",
        source="vidil_tpu_torch/csrc/grouped_expert_gemm.cu",
        replaces="none: the JAX package runs no mixture of experts",
        launches=nem["launches_by_chunk"][0],
        max_abs_err=max(r["max_abs_err"] for r in p20["kernel"]),
        shape="x (216000, 2688) over w (128, 1856, 2688) bf16, relu^2: the up projection of "
              "the LM cell's prefill (16 prompts, top 6 of 128); launches: the LM stage's eager "
              "first chunk",
        **{k: k7_prefill[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "library_ms")},
        launches_lm_by_chunk=nem["launches_by_chunk"],
        profiled_kernels_replayed_chunk=nem["replayed_chunk_profiled_kernels"],
        launches_kimi_by_chunk=kimi["launches_by_chunk"],
        profiled_kernels_replayed_kimi_chunk=kimi["replayed_chunk_profiled_kernels"],
        others={f"{r['model']}_{r['shape']}_{r['projection']}": {k: r[k] for k in (
            "ms", "device_ms", "bound_ms", "bound_by", "library_ms")} for r in p20["kernel"]}))
    k8 = p20["k8"]
    record["kernels"].append(dict(
        name="ssd_chunk_scan", route="cuda", source="vidil_tpu_torch/csrc/ssd_chunk_scan.cu",
        replaces="none: the JAX package has no state-space layer",
        launches=nem["k8_launches_by_chunk"][0], max_abs_err=k8["max_abs_err"],
        shape=f"x (T, 64, 64), B and C (T, 8, 128) bf16 views, T {k8['tokens']} over "
              f"{k8['prompts']} prompts: one Mamba layer of the LM cell's prefill; launches: "
              "the LM stage's eager first chunk",
        **{k: k8[k] for k in ("ms", "device_ms", "bound_ms", "bound_by", "plain_ms")},
        launches_lm_by_chunk=nem["k8_launches_by_chunk"]))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_nccl_world(world):
    """`--phase17-world N`: phase 17 (b) over N NCCL ranks, one GPU each
    (needs N cards): build the kernels, run the ranks, hold them to one
    process on cuda:0."""
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: --phase17-world {world} needs {world} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    from vidil_tpu_torch.ops import _build
    from vidil_tpu_torch.tokenizer import write_bench_vocab

    card = card_line()
    log("cards:", world, "x", card)
    t0 = time.time()
    _build.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        write_bench_vocab(os.path.join(root, "vocab.txt"))
        out = p17_ranks(torch.device("cuda", 0), bench_tokenizer(), root, world, "nccl")
    log(f"phase 17 (b) over {world} NCCL ranks: {time.time() - t0:.1f} s (ranks "
        f"{out['ranks_s']:.1f} s); cards {world} x {card}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 3 and sys.argv[1] == "--phase17-rank":
        p17_rank(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "--phase17-world":
        sys.exit(main_nccl_world(int(sys.argv[2])) if torch.cuda.is_available() else 1)
    if len(sys.argv) > 4 and sys.argv[1] == "--phase18-rank":
        p18_rank(sys.argv[2], sys.argv[3], int(sys.argv[4]))
        sys.exit(0)
    if len(sys.argv) > 2 and sys.argv[1] == "--phase18-world":
        sys.exit(main_p18_world(int(sys.argv[2])) if torch.cuda.is_available() else 1)
    if len(sys.argv) > 1 and sys.argv[1] == "--phase20":
        sys.exit(main_phase20())
    sys.exit(main())
