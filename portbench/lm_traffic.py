"""Traffic of the language-model cells: VidIL's few-shot caption prompts,
built by the port's own prompt templates (`vidil_tpu_torch.pipeline.
prompts.Prompt`, the layer `generate_prompts` writes its jsonl with) from
seeded synthetic frame captions and visual tokens, and the whole-word
vocabulary they are spelled in.

A prompt is VidIL's in-context caption prompt: the instruction line, then
`shots` examples, each a training video's Scene / Objects / Events /
Attributes / Frame Captions lines and its ``Video Caption:`` with the
caption, then the query video's lines ending in ``Video Caption:``,
joined by blank lines (`generate_prompts.save_prompt_lines_with_in_
context_selection`). The examples are chosen per query, as VidIL's
SBERT selection does: here by length from a seeded support set, so that
each prompt lands near a length drawn for it from `prompt_tokens`
= [lo, hi], and no two prompts share a prefix beyond the instruction line.

Vocabulary (`vocab`): the tokenizer's five specials, punctuation, the
templates' words, digits, then ``w0``, ``w1``, ... up to the model's
vocabulary size; every caption and visual-token word is a ``w`` entry.
"""

from __future__ import annotations

import os

import numpy as np

PUNCT = list(".,:;!?()[]'\"-")
TEMPLATE_WORDS = ("Scene Objects Events Attributes Frame Captions Video Caption Subtitle Question "
                  "Answer Dialogue First Then Finally After that What is likely to happen next "
                  "more A B Write a caption describes the video").split()
PROMPT_CONFIG = {
    "prompt_task": "caption", "add_objects": True, "add_events": True, "add_attributes": True,
    "add_scenes": True, "add_frame_captions": True, "add_ASR": False, "add_answer": False,
    "prompt_temporal_template": "temporal_natural", "visual_token_aggregation_version": "v2",
    "topk": 4,
}


def vocab(size: int) -> list[str]:
    head = _head()
    return head + [f"w{i}" for i in range(size - len(head))]


def _head() -> list[str]:
    from vidil_tpu_torch.pipeline.lm_answer import SPECIALS

    return SPECIALS + PUNCT + TEMPLATE_WORDS + [str(i) for i in range(100)]


def write_vocab(path: str, size: int) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab(size)) + "\n")
    return path


def vocab_path() -> str:
    return os.path.join(os.environ.get("TMPDIR") or ".", "portbench_lm_vocab.txt")


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def _words(rng, n: int, n_words: int) -> str:
    return " ".join(f"w{i}" for i in rng.integers(0, n_words, n))


def _video(rng, n_words: int, caption_words: int, frames: int = 8):
    """A synthetic video as the prompt layer takes it: per-frame visual
    tokens (two candidates a category) and `frames` frame captions of
    `caption_words` words, plus its original caption."""
    def tok():
        return [f"w{i}" for i in rng.integers(0, n_words, 2)]

    frame_tokens = [{"objects": tok(), "attributes": tok(), "scenes": tok(), "verbs": tok()}
                    for _ in range(frames)]
    captions = [_words(rng, caption_words, n_words) for _ in range(frames)]
    return {"frame_tokens": frame_tokens, "caption": _words(rng, caption_words, n_words)}, captions


def _instance(prompt, video, captions, with_caption: bool) -> str:
    config = dict(PROMPT_CONFIG, add_original_caption=with_caption)
    return prompt.construct_prompt("v", video, {"v": captions}, config)


def prompt_pool(t: dict, seed: int, tokenizer) -> list[list[str]]:
    """`pool_chunks` chunks of `prompts` prompts (see the module's
    docstring), each of about a length drawn uniformly from
    `prompt_tokens`, with `shots` examples from a support set of
    `support_set` videos whose captions have `caption_words` = [lo, hi]
    words."""
    from vidil_tpu_torch.pipeline.prompts import Prompt

    n_words = tokenizer_words(tokenizer)
    rng = _rng(seed, 11)
    plain = Prompt("", seed=42)
    lo, hi = t["caption_words"]
    support, support_len = [], []
    for _ in range(t["support_set"]):
        video, caps = _video(rng, n_words, int(rng.integers(lo, hi + 1)))
        s = _instance(plain, video, caps, True)
        support.append(s)
        support_len.append(len(tokenizer.encode(s)) - 1)
    support_len = np.asarray(support_len)
    instr = t["instruction_line"]
    pool = []
    for _ in range(t["pool_chunks"]):
        chunk = []
        for _ in range(t["prompts"]):
            target = int(rng.integers(t["prompt_tokens"][0], t["prompt_tokens"][1] + 1))
            video, caps = _video(rng, n_words, int(rng.integers(lo, hi + 1)))
            query = _instance(plain, video, caps, False)
            fixed = len(tokenizer.encode(instr + "\n\n" + query)) + 2 * t["shots"]
            per_shot = (target - fixed) / t["shots"]
            near = np.argsort(np.abs(support_len - per_shot), kind="stable")[: 4 * t["shots"]]
            chosen = _within(list(rng.choice(near, t["shots"], replace=False)), support_len,
                             fixed, t["prompt_tokens"])
            prefix = "\n\n".join([instr] + [support[i] for i in chosen]) + "\n\n"
            chunk.append(_instance(Prompt(prefix, seed=42), video, caps, False))
        pool.append(chunk)
    return pool


def _within(chosen, support_len, fixed: int, bounds) -> list:
    """The chosen shots, the longest swapped for the shortest shot outside
    them while the prompt (fixed + 2 line breaks and the shots' tokens)
    passes the upper bound, and the shortest for the longest while it falls
    short of the lower."""
    lo, hi = bounds
    order = np.argsort(support_len, kind="stable")
    for _ in range(len(support_len)):
        total = fixed + int(support_len[chosen].sum())
        free = [i for i in order if i not in chosen]
        if total > hi:
            out, new = max(chosen, key=lambda i: support_len[i]), free[0]
        elif total < lo:
            out, new = min(chosen, key=lambda i: support_len[i]), free[-1]
        else:
            return chosen
        chosen = [new if i == out else i for i in chosen]
    raise ValueError(f"no {len(chosen)} shots bring a prompt within {bounds} tokens")


def tokenizer_words(tokenizer) -> int:
    """How many ``w`` words the tokenizer's vocabulary holds."""
    return len(tokenizer.vocab) - len(_head())
