"""Joint frame x sentence ITM selection for single-frame pretraining.

Counterpart of ``vidil_tpu/train/frame_selection.py`` (reference:
pretrain_video.py:30-63): split the caption into sentences, score every
(frame, sentence) pair with the ITM head in one grouped call (each frame's
memory shared by all the sentences), keep the best pair.
"""

from __future__ import annotations

import re

import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.pipeline.sentences import split_sentences

_PUNCT_RE = re.compile(r"([*#/:;~])")


def sentence_tokenization(original_caption: str) -> list[str]:
    """Lowercased sentences longer than 3 characters, punctuation such as
    ``*#/:;~`` read as a sentence end; the caption itself when none is left
    (reference: pretrain_video.py:30-44)."""
    caption = original_caption.replace("\n", ". ")
    caption = _PUNCT_RE.sub(". ", caption.lower())
    sentences = [s.strip() for s in split_sentences(caption) if len(s.strip()) > 3]
    return sentences or [original_caption.strip()]


@torch.no_grad()
def select_frame_and_sentence(filterer_params, frames, text: str, tokenizer,
                              vit_cfg: ViTConfig, med_cfg: MedConfig, dtype=None):
    """frames (N, S, S, C) normalized + caption -> (best frame, best sentence),
    with the reference's flat-argmax order (sentence-major: idx % N is the
    frame, idx // N the sentence)."""
    num_frm = frames.shape[0]
    sentences = sentence_tokenization(text)
    enc = tokenizer(sentences, padding="max_length", truncation=True, max_length=35)
    device = filterer_params["itm_head"]["kernel"].device
    embeds = B.encode_images(filterer_params, torch.as_tensor(frames, device=device),
                             vit_cfg, dtype=dtype)
    n = len(sentences)
    ids = torch.as_tensor(enc.input_ids, device=device).long().repeat(num_frm, 1)
    mask = torch.as_tensor(enc.attention_mask, device=device).long().repeat(num_frm, 1)
    logits = B.blip_itm_scores(filterer_params, embeds, ids, mask, med_cfg, dtype=dtype,
                               group_size=n)
    score = torch.softmax(logits, dim=1)[:, 1].reshape(num_frm, n).t().reshape(-1)
    idx = int(score.argmax())
    return frames[idx % num_frm], sentences[idx // num_frm]
