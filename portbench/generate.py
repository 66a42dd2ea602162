"""The one traffic generator: makes a cell's inputs from its traffic
parameters (`portbench/workloads/<cell>.json`, key ``traffic``) and the
run's seed, on the host, as the port's CLIs hand them to the engine or the
train step.

Vocabulary: `write_vocab` writes the 30524-entry synthetic BERT vocabulary
the benchmark's captions are spelled in (ids 4-99 ``word0``-``word95``,
104-30521 ``tok0``-``tok30417``; BLIP's [DEC] and [ENC] follow the file at
30522 and 30523). Every word a caption uses is one whole vocabulary entry,
so BERT tokenization is a lookup (`word_ids`).
"""

from __future__ import annotations

import os

import numpy as np

PAD, UNK, CLS, SEP = 0, 100, 101, 102
DEC = 30522  # BLIP's [DEC] bos, appended after the file's 30522 entries
_BASE = (["[PAD]", "a", "picture", "of"] + [f"word{i}" for i in range(96)]
         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
VOCAB = _BASE + [f"tok{i}" for i in range(30418)]
SPECIAL_IDS = frozenset({PAD, UNK, CLS, SEP, 103, DEC, DEC + 1})
WORD_IDS = np.concatenate([np.arange(4, 100), np.arange(104, len(VOCAB))])
_INDEX = {w: i for i, w in enumerate(VOCAB)}


def write_vocab(path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(VOCAB) + "\n")
    return path


def word_ids(text: str) -> list[int]:
    """BERT's tokenization of a lower-case caption of vocabulary words."""
    return [_INDEX.get(w, UNK) for w in text.lower().split()]


def decode(ids) -> str:
    """Ids -> words joined by spaces, special tokens skipped."""
    return " ".join(VOCAB[i] for i in ids if i not in SPECIAL_IDS and i < len(VOCAB))


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def _caption(rng, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return " ".join(VOCAB[i] for i in rng.choice(WORD_IDS, n))


def capfilt_pool(t: dict, seed: int) -> list[list[dict]]:
    """`pool_chunks` distinct chunks of `videos` videos: each video `frames`
    uint8 RGB frames of `image_size`, and `captions` original captions of
    `caption_words` = [lo, hi] words."""
    rng = _rng(seed, 1)
    S, F = t["image_size"], t["frames"]
    lo, hi = t["caption_words"]
    pool = []
    for c in range(t["pool_chunks"]):
        frames = rng.integers(0, 256, (t["videos"], F, S, S, 3), dtype=np.uint8)
        pool.append([{"video_id": f"c{c}v{v}", "frames": frames[v],
                      "text": [_caption(rng, lo, hi) for _ in range(t["captions"])]}
                     for v in range(t["videos"])])
    return pool


def caption_row(t: dict, seed: int, batch: int, row: int):
    """Row `row` of global train batch `batch`: (`frames` normalized
    frames of `image_size`, float32 standard normal; ids and mask of
    `tokens`: [DEC], the prompt's words, `caption_words` words, [SEP],
    pads). Drawn from (seed, batch, row) alone, so a rank makes its own
    rows and the reference the whole batch."""
    rng = _rng(seed, 2, batch, row)
    S, L = t["image_size"], t["tokens"]
    video = rng.standard_normal((t["frames"], S, S, 3), dtype=np.float32)
    prompt = word_ids(t["prompt"])
    lo, hi = t["caption_words"]
    words = word_ids(_caption(rng, lo, hi))
    ids = ([DEC] + prompt + words)[: L - 1] + [SEP]
    row_ids = np.zeros(L, np.int64)
    row_mask = np.zeros(L, np.int64)
    row_ids[: len(ids)] = ids
    row_mask[: len(ids)] = 1
    return video, row_ids, row_mask


def caption_batch(t: dict, seed: int, batch: int, rows) -> dict:
    """Train batch `batch`'s rows `rows` (a range), stacked as the CLI's
    loader hands them: video (B, N, S, S, 3), input_ids and attention_mask
    (B, L)."""
    parts = [caption_row(t, seed, batch, r) for r in rows]
    return {"video": np.stack([p[0] for p in parts]),
            "input_ids": np.stack([p[1] for p in parts]),
            "attention_mask": np.stack([p[2] for p in parts])}


def prompt_length(t: dict) -> int:
    """Decoder positions before the caption: [DEC] and the prompt's words."""
    return 1 + len(word_ids(t["prompt"]))


def vocab_path() -> str:
    """Where a run writes the vocabulary: under TMPDIR."""
    return os.path.join(os.environ.get("TMPDIR") or ".", "portbench_vocab.txt")
