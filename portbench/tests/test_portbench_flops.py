"""`flops.py` against counts made by hand at tiny shapes."""

from __future__ import annotations

import pytest

import flops

VIT = {"image_size": 32, "patch_size": 16, "hidden_size": 8, "num_layers": 2, "num_heads": 2,
       "mlp_ratio": 4.0}
MED = {"hidden_size": 8, "intermediate_size": 32, "num_layers": 2, "vocab_size": 100,
       "encoder_width": 8}


def test_vit_flops_by_hand():
    # 4 patches of 16*16*3 -> 8; 5 tokens; per block qkv 5*8*24, proj 5*8*8,
    # fc1 5*8*32, fc2 5*32*8, two attention products 5*5*8 each; 2 per MAC
    patch = 2 * 4 * 768 * 8
    block = 2 * (5 * 8 * 24 + 5 * 8 * 8 + 5 * 8 * 32 + 5 * 32 * 8 + 2 * 5 * 5 * 8)
    assert flops.vit_flops(3, VIT) == 3 * (patch + 2 * block)


def test_med_token_and_memory_by_hand():
    # q, k, v, out 4*8*8; attention 2*3*8; cross q, out 2*8*8; cross attention
    # 2*5*8; FFN 2*8*32; 2 per MAC, 2 layers
    per = 2 * (4 * 64 + 2 * 3 * 8 + 2 * 64 + 2 * 5 * 8 + 2 * 8 * 32)
    assert flops.med_token_flops(MED, 3, 5) == 2 * per
    assert flops.med_memory_flops(MED, 5) == 2 * 2 * (2 * 5 * 8 * 8)
    assert flops.lm_head_flops(MED) == 2 * (64 + 8 * 100)


def test_beam_decode_by_hand():
    cfg = {"vit": VIT, "med": MED,
           "generation": {"num_beams": 2, "prompt_length": 2, "max_length": 4}}
    Lk = 5
    want = flops.med_memory_flops(MED, Lk)
    want += 2 * (2 * flops.med_token_flops(MED, 2, Lk) + flops.lm_head_flops(MED))
    want += 2 * (flops.med_token_flops(MED, 3, Lk) + flops.lm_head_flops(MED))  # step at 2
    assert flops.beam_decode_flops(1, cfg) == want


def test_caption_step_is_three_forwards_less_patch_input_gradient():
    cfg = {"vit": VIT, "med": MED}
    fwd_vit = flops.vit_flops(2, VIT)
    mem = 2 * 5
    fwd_med = flops.med_memory_flops(MED, mem) + 4 * (
        flops.med_token_flops(MED, 4, mem) + flops.lm_head_flops(MED))
    assert flops.caption_step_flops(cfg, 2, [4]) == 3 * (fwd_vit + fwd_med) - \
        flops.vit_patch_flops(2, VIT)


def test_kernel_bounds():
    # one K1 call: bytes 2*(q + k) elements of 2 bytes vs 4*B*H*Lq*Lk*D operations
    b = flops.attention_bound_s(1, 1, 64, 64, 64)
    assert b == pytest.approx(max(4 * 64 ** 3 / flops.PEAK_BF16,
                                  (2 * 64 * 64 * 2) * 2 / flops.PEAK_BYTES))
    D = 128
    fwd = 2 * 4 * 10 * D * (4 * D + 8 * D + 2 * 10)
    assert flops.block_flops(4, 10, D) == fwd and flops.block_flops(4, 10, D, True) == 3 * fwd
    w = 12 * D * D
    assert flops.block_bound_s(4, 10, D) == pytest.approx(
        max(fwd / flops.PEAK_BF16, (2 * 40 * D + w) * 2 / flops.PEAK_BYTES))
