"""Operations and bytes from shapes, and the H100's published peaks.

The matmul operations a BLIP CapFilt chunk and a caption-training step
need for their inputs (2 per multiply-add; LayerNorms, softmaxes and
elementwise work are not counted), and the least time of one K1 (flash
attention forward) and one K4 / K5 (fused ViT block forward / backward)
call: the larger of their operations over the peak rate and their bytes
over the memory bandwidth. Real tokens only: 577 or 197 image tokens, not
the kernels' padded tiles; a text row's real tokens, not its pads.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W power limit
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_FP32 = 67e12  # FLOP/s outside them
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def attention_bound_s(B: int, H: int, Lq: int, Lk: int, D: int, itemsize: int = 2,
                      with_lse: bool = False) -> float:
    """One K1 call: q, k, v read once and o (and fp32 lse rows) written
    once, or its 4*B*H*Lq*Lk*D operations."""
    nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * itemsize + with_lse * B * H * Lq * 4
    return bound_s(4 * B * H * Lq * Lk * D, nbytes)


def block_flops(B: int, L: int, D: int, backward: bool = False) -> float:
    """One fused ViT block call over B frames of L tokens: the forward's
    2*B*L*D*(4D + 2Dm + 2L) (qkv, proj, fc1, fc2 and the two attention
    products); the backward three times that (the recompute, and two
    products per forward product)."""
    Dm = 4 * D
    return 2 * B * L * D * (4 * D + 2 * Dm + 2 * L) * (3 if backward else 1)


def block_bound_s(B: int, L: int, D: int, backward: bool = False, itemsize: int = 2) -> float:
    """One K4 (forward) or K5 (backward) call: its operations, or its bytes:
    x and out (backward: x, the output gradient and dx) and the weights
    read once (backward: also their fp32 gradients written)."""
    weights = 4 * D * D + 2 * D * 4 * D
    nbytes = (3 * B * L * D * itemsize + weights * (itemsize + 4) if backward
              else (2 * B * L * D + weights) * itemsize)
    return bound_s(block_flops(B, L, D, backward), nbytes)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def vit_flops(frames: int, vit: dict) -> float:
    """The ViT forward over `frames` images: patch embedding, and per block
    qkv, proj, fc1, fc2 and the two attention products."""
    D, P = vit["hidden_size"], vit["patch_size"]
    n = (vit["image_size"] // P) ** 2
    L = n + 1
    Dm = int(D * vit["mlp_ratio"])
    block = 2 * L * D * (4 * D + 2 * Dm) + 4 * L * L * D
    return frames * (2 * n * P * P * 3 * D + vit["num_layers"] * block)


def vit_patch_flops(frames: int, vit: dict) -> float:
    D, P = vit["hidden_size"], vit["patch_size"]
    return frames * 2 * (vit["image_size"] // P) ** 2 * P * P * 3 * D


def med_token_flops(med: dict, context: int, memory_len: int) -> float:
    """One text token through every MED layer: self q, k, v, out over its
    `context` tokens, cross q and out over `memory_len` memory tokens (0:
    no cross-attention), and the FFN."""
    D, Dm = med["hidden_size"], med["intermediate_size"]
    per = 8 * D * D + 4 * context * D + 4 * D * Dm
    if memory_len:
        per += 4 * D * D + 4 * memory_len * D
    return med["num_layers"] * per


def med_memory_flops(med: dict, memory_len: int) -> float:
    """The cross-attention keys and values of one memory, every layer."""
    return med["num_layers"] * 4 * memory_len * med["encoder_width"] * med["hidden_size"]


def lm_head_flops(med: dict) -> float:
    D = med["hidden_size"]
    return 2 * D * D + 2 * D * med["vocab_size"]


def med_rows_flops(med: dict, lengths, memory_len: int) -> float:
    """Text rows of the given real lengths, full attention within a row."""
    return sum(n * med_token_flops(med, n, memory_len) for n in lengths)


def beam_decode_flops(frames: int, cfg: dict) -> float:
    """The beam decode over `frames` images: the cross keys and values once
    per image, the prompt's prefill per beam (logits at its last position),
    then one token per beam and step to max_length, attending the tokens
    before it."""
    med, g = cfg["med"], cfg["generation"]
    nb, Lp, T = g["num_beams"], g["prompt_length"], g["max_length"]
    Lk = (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2 + 1
    per_frame = med_memory_flops(med, Lk)
    per_frame += nb * (Lp * med_token_flops(med, Lp, Lk) + lm_head_flops(med))
    for t in range(Lp, T - 1):
        per_frame += nb * (med_token_flops(med, t + 1, Lk) + lm_head_flops(med))
    return frames * per_frame


def itm_flops(memories: int, text_lengths_per_memory, cfg: dict) -> float:
    """The grouped ITM: each memory's keys and values once, and every text
    row scored against it."""
    med = cfg["med"]
    Lk = (cfg["vit"]["image_size"] // cfg["vit"]["patch_size"]) ** 2 + 1
    total = memories * med_memory_flops(med, Lk)
    for lengths in text_lengths_per_memory:
        total += med_rows_flops(med, lengths, Lk)
    return total


def caption_step_flops(cfg: dict, frames_per_video: int, text_lengths) -> float:
    """One caption-training step: the ViT over every frame and the MED
    decoder (with its LM head at every real position) over each video's
    concatenated frame tokens, forward and backward (two products per
    forward product, the patch embedding's input gradient excepted); no
    recompute counted."""
    vit, med = cfg["vit"], cfg["med"]
    videos = len(text_lengths)
    frames = videos * frames_per_video
    L_img = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
    memory_len = frames_per_video * L_img
    fwd_vit = vit_flops(frames, vit)
    fwd_med = videos * med_memory_flops(med, memory_len) + sum(
        n * (med_token_flops(med, n, memory_len) + lm_head_flops(med)) for n in text_lengths)
    return 3 * (fwd_vit + fwd_med) - vit_patch_flops(frames, vit)
