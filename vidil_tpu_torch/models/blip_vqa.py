"""BLIP video VQA: the question encoder cross-attends the video tokens, the
answer decoder cross-attends the question states.

Counterpart of ``vidil_tpu/models/blip_vqa.py``. Training uses per-answer
weights over a flattened ragged answer list (`vqa_train_loss`); inference is
beam generation (`vqa_generate_ids`) or first-token top-k answer ranking
(`rank_answer`).
"""

from __future__ import annotations

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.blip import make_decoder_closures, med_shapes, vit_shapes
from vidil_tpu_torch.ops.generation import GenerationConfig, _topk_stable, beam_search


def encode_question(params, video_embeds, question_ids, question_mask,
                    med_cfg: MedConfig, dtype=None):
    """Question encoder over the video tokens ([ENC]-prefixed ids); every
    video token is attended (the reference's all-ones mask)."""
    video_atts = torch.ones(video_embeds.shape[:2], dtype=torch.int32, device=video_embeds.device)
    return M.med_forward(
        params["text_encoder"], question_ids, question_mask,
        encoder_hidden_states=video_embeds, encoder_attention_mask=video_atts,
        cfg=med_cfg, mode="multimodal", dtype=dtype,
    )


def vqa_train_loss(params, video_embeds, question_ids, question_mask,
                   answer_ids, answer_mask, answer_question_index, weights,
                   med_cfg: MedConfig, batch_size: int, dtype=None):
    """Weighted answer LM loss: the flattened answers carry
    ``answer_question_index`` (each answer's question row), gathered instead
    of the reference's per-question repeat. loss = sum(weights * per-answer
    loss) / B."""
    question_states = encode_question(params, video_embeds, question_ids,
                                      question_mask, med_cfg, dtype=dtype)
    index = answer_question_index.long()
    q_states = question_states[index]
    q_mask = question_mask[index]
    labels = torch.where(answer_mask == 1, answer_ids, torch.full_like(answer_ids, -100))
    hidden = M.med_forward(
        params["text_decoder"], answer_ids, answer_mask,
        encoder_hidden_states=q_states, encoder_attention_mask=q_mask,
        cfg=med_cfg, mode="multimodal", is_decoder=True, dtype=dtype,
    )
    logits = M.med_lm_logits(params["text_decoder"], hidden, med_cfg, dtype=dtype)
    per_answer = M.med_lm_loss(logits, labels, label_smoothing=med_cfg.label_smoothing,
                               reduction="none")
    return (weights * per_answer).sum() / batch_size


def vqa_generate_ids(params, video_embeds, question_ids, question_mask,
                     med_cfg: MedConfig, tokenizer, max_length: int = 10,
                     num_beams: int = 3, dtype=None, length_norm: str = "legacy",
                     beam_group_kv: bool = False):
    """Beam-search answers conditioned on the question states, from [DEC].
    Every question position is attended (the reference's all-ones mask, a
    zero bias, which the port leaves out). beam_group_kv=True keeps the
    cross K/V at batch B; the tokens are the same either way."""
    B = video_embeds.shape[0]
    question_states = encode_question(params, video_embeds, question_ids,
                                      question_mask, med_cfg, dtype=dtype)
    kv_src = question_states if beam_group_kv else question_states.repeat_interleave(num_beams, 0)
    beam_size = num_beams if beam_group_kv else 1
    cross_k, cross_v = M.precompute_cross_kv(params["text_decoder"], kv_src, med_cfg, dtype=dtype)
    gen = GenerationConfig(max_length=max_length, min_length=1, num_beams=num_beams,
                           eos_token_id=tokenizer.sep_token_id,
                           pad_token_id=tokenizer.pad_token_id, length_norm=length_norm)
    cache = M.init_self_cache(med_cfg, B * num_beams, gen.max_length,
                              dtype=dtype or torch.float32, device=video_embeds.device)
    prefill_fn, step_fn, reorder_fn = make_decoder_closures(
        params, cross_k, cross_v, None, med_cfg, dtype=dtype, beam_size=beam_size)
    bos = torch.full((B, 1), tokenizer.bos_token_id, dtype=torch.int32,
                     device=video_embeds.device)
    seqs, _ = beam_search(bos, cache, prefill_fn, step_fn, reorder_fn, gen)
    return seqs


def rank_answer(params, video_embeds, question_ids, question_mask,
                answer_ids, answer_mask, k: int, med_cfg: MedConfig,
                tokenizer, dtype=None):
    """Answer ranking: first-token probability -> the top-k candidate
    answers (ties to the lower index, as jax.lax.top_k) -> rerank by the
    full answer's log-probability. The k candidates of one question share
    its encoded states through grouped cross-attention. Returns (B,)
    indices into the answer list."""
    question_states = encode_question(params, video_embeds, question_ids,
                                      question_mask, med_cfg, dtype=dtype)
    num_ques = question_states.shape[0]
    device = question_states.device
    start_ids = torch.full((num_ques, 1), int(answer_ids[0, 0]), dtype=torch.int32, device=device)
    hidden = M.med_forward(
        params["text_decoder"], start_ids, torch.ones_like(start_ids),
        encoder_hidden_states=question_states, encoder_attention_mask=question_mask,
        cfg=med_cfg, mode="multimodal", is_decoder=True, dtype=dtype,
    )
    logits = M.med_lm_logits(params["text_decoder"], hidden[:, 0, :], med_cfg, dtype=dtype).float()
    prob_first = torch.softmax(logits, dim=1)[:, answer_ids[:, 1].long()]  # (B, n_answers)
    _, topk_ids = _topk_stable(prob_first, k)  # (B, k)

    flat = topk_ids.reshape(-1)
    input_ids = answer_ids[flat]
    input_atts = answer_mask[flat]
    targets = torch.where(input_ids == tokenizer.pad_token_id,
                          torch.full_like(input_ids, -100), input_ids)
    hidden = M.med_forward(
        params["text_decoder"], input_ids, input_atts,
        encoder_hidden_states=question_states, encoder_attention_mask=question_mask,
        cfg=med_cfg, mode="multimodal", is_decoder=True, dtype=dtype, group_size=k,
    )
    logits = M.med_lm_logits(params["text_decoder"], hidden, med_cfg, dtype=dtype)
    loss = M.med_lm_loss(logits, targets, label_smoothing=med_cfg.label_smoothing,
                         reduction="none")
    best = (-loss).reshape(num_ques, k).argmax(dim=1)
    return topk_ids.gather(1, best[:, None])[:, 0]


def blip_vqa_shapes(vit_cfg: ViTConfig, med_cfg: MedConfig) -> dict:
    """Parameter shapes in the JAX package's layout, for utils/synth.py."""
    return {"visual_encoder": vit_shapes(vit_cfg),
            "text_encoder": med_shapes(med_cfg),
            "text_decoder": med_shapes(med_cfg, with_lm_head=True)}
