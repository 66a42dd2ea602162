"""The plain reference against the port at tiny widths, both in float32 on
the CPU, on the benchmark's own weights: the ViT, the decoder's logits and
caption loss with its gradients, and the ITM probabilities, grouped and
not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import generate
import tiny
import weights
from reference import judge_train
from reference import model as M

ATOL = 1e-5  # float32 against float32: summation order only


@pytest.fixture(scope="module")
def setup():
    from vidil_tpu_torch.config import MedConfig, ViTConfig

    cfg = tiny.config("blip_capfilt_base384")
    cap = weights.draw(weights.captioner_spec(cfg), 7, "cpu", salt=1)
    fil = weights.draw(weights.filterer_spec(cfg), 7, "cpu", salt=2)
    return cfg, cap, fil, ViTConfig(**cfg["vit"]), MedConfig(**cfg["med"])


def _frames(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))


def test_weights_from_seed(setup):
    cfg = setup[0]
    a = weights.draw(weights.captioner_spec(cfg), 7, "cpu", salt=1)
    b = weights.draw(weights.captioner_spec(cfg), 8, "cpu", salt=1)
    la, lb = dict(weights.leaves(a)), dict(weights.leaves(b))
    w = la[("visual_encoder", "blocks", 0, "attn", "qkv", "kernel")]
    assert torch.equal(w, dict(weights.leaves(setup[1]))[
        ("visual_encoder", "blocks", 0, "attn", "qkv", "kernel")])
    assert not torch.equal(w, lb[("visual_encoder", "blocks", 0, "attn", "qkv", "kernel")])
    assert w.abs().max() <= 0.04 and abs(w.std().item() - 0.8796 * 0.02) < 0.002
    assert torch.equal(la[("visual_encoder", "norm", "scale")], torch.ones(64))


def test_vit(setup):
    from vidil_tpu_torch.models.vit import vit_forward
    from vidil_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD, preprocess_any

    cfg, cap, _, vit_cfg, _ = setup
    u8 = _frames(3)
    x_port = preprocess_any(u8, 32, CLIP_MEAN, CLIP_STD)
    x_ref = M.normalize_uint8(u8)
    torch.testing.assert_close(x_ref, x_port, atol=ATOL, rtol=0)
    got = vit_forward(cap["visual_encoder"], x_port, vit_cfg)
    want = M.vit(cap["visual_encoder"], x_ref, cfg["vit"])
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)


def test_decoder_logits_and_loss(setup):
    from vidil_tpu_torch.models import blip as B
    from vidil_tpu_torch.models import med

    cfg, cap, _, vit_cfg, med_cfg = setup
    emb = M.vit(cap["visual_encoder"], M.normalize_uint8(_frames(2)), cfg["vit"])
    ids = torch.tensor([[generate.DEC, 1, 2, 3, 500, 600, generate.SEP, 0],
                        [generate.DEC, 1, 2, 3, 700, generate.SEP, 0, 0]])
    mask = (torch.arange(8)[None] <= torch.tensor([[6], [5]])).long()
    h = med.med_forward(cap["text_decoder"], ids, mask, encoder_hidden_states=emb, cfg=med_cfg,
                        mode="multimodal", is_decoder=True)
    got = med.med_lm_logits(cap["text_decoder"], h, med_cfg)
    want = M.lm_logits(cap["text_decoder"], M.med(cap["text_decoder"], ids, mask, emb,
                                                   cfg["med"], causal=True), cfg["med"])
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], atol=ATOL, rtol=1e-5)
    loss_port = B.blip_caption_loss(cap, emb, ids, mask, med_cfg, prompt_length=4)
    loss_ref, n = M.caption_loss(cap, emb, ids, mask, 4, cfg["med"])
    assert n == 5
    torch.testing.assert_close(loss_port, loss_ref, atol=ATOL, rtol=1e-6)


def test_itm_grouped_and_not(setup):
    from vidil_tpu_torch.models import blip as B

    cfg, _, fil, _, med_cfg = setup
    mem = M.vit(fil["visual_encoder"], M.normalize_uint8(_frames(2, seed=1)), cfg["vit"])
    rows = [[generate.CLS, 5, 6, 7, generate.SEP], [generate.CLS, 9, generate.SEP, 0, 0]]
    ids = torch.tensor(rows * 2)
    mask = (ids != 0).long()
    logits = B.blip_itm_scores(fil, mem, ids, mask, med_cfg, group_size=2)
    got = torch.softmax(logits, dim=1)[:, 1]
    grouped = M.itm_probs(fil, ids, mask, mem, cfg["med"], group=2)
    flat = M.itm_probs(fil, ids, mask, mem.repeat_interleave(2, dim=0), cfg["med"])
    torch.testing.assert_close(grouped, flat, atol=ATOL, rtol=0)
    torch.testing.assert_close(got, grouped, atol=ATOL, rtol=0)


def test_reference_gradients_match_the_port(setup):
    """One step's gradients of the plain caption loss and of the port's, on
    the same fp32 weights and batch, with the port's step on the CPU."""
    from vidil_tpu_torch.config import MedConfig, ViTConfig
    from vidil_tpu_torch.train.caption import create_caption_train_state, make_caption_train_step

    cfg = tiny.config("blip_caption_base224")
    t = tiny.traffic("msrvtt_b12")
    params = weights.draw(weights.captioner_spec(cfg), 9, "cpu", salt=1)
    state = create_caption_train_state(params, 5e-6, 0.05, device="cpu")
    step = make_caption_train_step(ViTConfig(**cfg["vit"]), MedConfig(**cfg["med"]),
                                   generate.prompt_length(t))
    batches = judge_train.global_batches(t, 9, 1)
    state, m = step(state, batches[0])
    prog = judge_train.program_reading(state, params, 1)
    ref = judge_train.reference_steps(cfg, params, batches, generate.prompt_length(t), "cpu")
    assert abs(float(m["loss"]) - ref["losses"][0]) < 1e-5
    worst = max(abs(prog[k] - ref["g1"][k]) / max(ref["g1"][k], 1e-12) for k in ref["g1"]
                if ref["g1"][k] > 1e-6)
    assert worst < 1e-3


def test_fp8_control_rounds_operands():
    x = torch.randn(64, 64)
    y = M.fp8_round(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert 1e-3 < rel < 0.1 and not torch.equal(x, y)
