"""Tokenizers for the BLIP, CLIP and SBERT text sides (host code, no torch).

The port's own copy of the JAX package's tokenizer (``BasicTokenizer``,
``WordPieceTokenizer``, ``Encoding``, ``BlipTokenizer``, the SBERT
``MPNetTokenizer``, the CLIP BPE ``ClipBPETokenizer``, ``trimmed_pad_len``
and the vocab writers), so that ``vidil_tpu_torch`` imports nothing of
``vidil_tpu``.
Compatible with HF ``BertTokenizer``: bert-base-uncased vocab + '[DEC]'
bos + '[ENC]' (vocab 30524), as in BLIP's ``init_tokenizer``.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass, field

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-letter/number blocks are treated as punctuation (HF behavior)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """HF BasicTokenizer: clean, CJK-space, lowercase+strip accents, split punct."""

    def __init__(self, do_lower_case: bool = True, never_split=None,
                 strip_accents: bool | None = None, do_split_on_punc: bool = True):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or [])
        self.strip_accents = strip_accents
        self.do_split_on_punc = do_split_on_punc

    def tokenize(self, text: str, never_split=None) -> list[str]:
        never_split = self.never_split | set(never_split or [])
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        orig_tokens = text.split()
        split_tokens: list[str] = []
        for token in orig_tokens:
            if token not in never_split:
                if self.do_lower_case:
                    token = token.lower()
                    if self.strip_accents is not False:
                        token = self._strip_accents(token)
                elif self.strip_accents:
                    token = self._strip_accents(token)
                if self.do_split_on_punc:
                    split_tokens.extend(self._split_on_punc(token, never_split))
                else:
                    split_tokens.append(token)
            else:
                split_tokens.append(token)
        return " ".join(split_tokens).split()

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text: str, never_split) -> list[str]:
        if text in never_split:
            return [text]
        output: list[list[str]] = []
        start_new_word = True
        for ch in text:
            if _is_punctuation(ch):
                output.append([ch])
                start_new_word = True
            else:
                if start_new_word:
                    output.append([])
                start_new_word = False
                output[-1].append(ch)
        return ["".join(x) for x in output]


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece."""

    def __init__(self, vocab: dict, unk_token: str = "[UNK]", max_chars: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars = max_chars

    def tokenize(self, text: str) -> list[str]:
        output: list[str] = []
        for token in text.split():
            if len(token) > self.max_chars:
                output.append(self.unk_token)
                continue
            is_bad = False
            start = 0
            sub_tokens: list[str] = []
            while start < len(token):
                end = len(token)
                cur = None
                while start < end:
                    substr = token[start:end]
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            output.extend([self.unk_token] if is_bad else sub_tokens)
        return output


@dataclass
class Encoding:
    input_ids: np.ndarray  # (B, L) int32
    attention_mask: np.ndarray  # (B, L) int32


class BlipTokenizer:
    """BertTokenizer-compatible tokenizer with BLIP's special tokens.

    Token ids follow bert-base-uncased: [PAD]=0, [UNK]=100, [CLS]=101,
    [SEP]=102, [MASK]=103; BLIP appends bos '[DEC]' and '[ENC]'
    (reference: models/blip.py:290-295), giving vocab 30524.
    """

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 add_blip_special_tokens: bool = True):
        self.vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.pad_token = "[PAD]"
        self.unk_token = "[UNK]"
        self.cls_token = "[CLS]"
        self.sep_token = "[SEP]"
        self.mask_token = "[MASK]"
        special = {self.pad_token, self.unk_token, self.cls_token, self.sep_token, self.mask_token}
        if add_blip_special_tokens:
            for tok in ("[DEC]", "[ENC]"):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)
            self.bos_token = "[DEC]"
            self.bos_token_id = self.vocab["[DEC]"]
            self.enc_token_id = self.vocab["[ENC]"]
            special |= {"[DEC]", "[ENC]"}
        self.special_tokens = special
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.pad_token_id = self.vocab[self.pad_token]
        self.cls_token_id = self.vocab[self.cls_token]
        self.sep_token_id = self.vocab[self.sep_token]
        self.unk_token_id = self.vocab[self.unk_token]
        self.basic = BasicTokenizer(do_lower_case=do_lower_case, never_split=special)
        self.wordpiece = WordPieceTokenizer(self.vocab, self.unk_token)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> list[str]:
        tokens: list[str] = []
        for tok in self.basic.tokenize(text, never_split=self.special_tokens):
            if tok in self.special_tokens:
                tokens.append(tok)
            else:
                tokens.extend(self.wordpiece.tokenize(tok))
        return tokens

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: int | None = None, truncation: bool = False) -> list[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation and max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def __call__(self, texts, padding: str = "longest", truncation: bool = False,
                 max_length: int | None = None) -> Encoding:
        """HF-call-compatible batch encode -> numpy arrays.

        padding: 'longest' | 'max_length' | 'none'.
        """
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t, max_length=max_length, truncation=truncation) for t in texts]
        if padding == "max_length":
            assert max_length is not None
            L = max_length
        elif padding == "longest":
            L = max(len(s) for s in seqs)
        else:
            L = max(len(s) for s in seqs)
            assert all(len(s) == L for s in seqs), "padding='none' requires equal lengths"
        ids = np.full((len(seqs), L), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return Encoding(input_ids=ids, attention_mask=mask)

    def convert_tokens_to_string(self, tokens: list[str]) -> str:
        return " ".join(tokens).replace(" ##", "").strip()

    @staticmethod
    def clean_up_tokenization(text: str) -> str:
        """HF clean_up_tokenization_spaces."""
        return (
            text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re")
        )

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in np.asarray(ids).tolist():
            tok = self.ids_to_tokens.get(int(i), self.unk_token)
            if skip_special_tokens and tok in self.special_tokens:
                continue
            tokens.append(tok)
        return self.clean_up_tokenization(self.convert_tokens_to_string(tokens))

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch_ids)]


class MPNetTokenizer(BlipTokenizer):
    """HF MPNetTokenizer-compatible WordPiece tokenizer.

    Same WordPiece machinery as BERT but with roberta-style specials:
    ``<s>`` (cls/bos), ``</s>`` (sep/eos), ``<pad>``, ``<mask>``; the unk
    token is ``[UNK]`` when present in the vocab (the all-mpnet-base-v2
    layout) else ``<unk>``. Used for the SBERT in-context-selection /
    answer-mapping encoder (reference: SentenceTransformer
    'all-mpnet-base-v2').
    """

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        self.vocab = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.pad_token = "<pad>"
        self.cls_token = "<s>"
        self.sep_token = "</s>"
        self.mask_token = "<mask>"
        self.unk_token = "[UNK]" if "[UNK]" in self.vocab else "<unk>"
        special = {self.pad_token, self.cls_token, self.sep_token,
                   self.mask_token, self.unk_token, "<unk>"}
        self.special_tokens = {t for t in special if t in self.vocab} | {self.unk_token}
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.pad_token_id = self.vocab[self.pad_token]
        self.cls_token_id = self.vocab[self.cls_token]
        self.sep_token_id = self.vocab[self.sep_token]
        self.unk_token_id = self.vocab[self.unk_token]
        self.bos_token_id = self.cls_token_id
        self.basic = BasicTokenizer(do_lower_case=do_lower_case, never_split=self.special_tokens)
        self.wordpiece = WordPieceTokenizer(self.vocab, self.unk_token)


# ---------------------------------------------------------------------------
# CLIP BPE
# ---------------------------------------------------------------------------

def bytes_to_unicode() -> dict:
    """GPT-2/CLIP reversible byte<->unicode map (printable chars preferred)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ClipBPETokenizer:
    """CLIPTokenizer-compatible BPE (vocab.json + merges.txt), offline.

    Matches HF's non-ftfy path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False) cleanup, word regex, byte-to-unicode mapping,
    end-of-word '</w>' BPE. Used by the CLIP visual-tokenization text side
    (reference: run_visual_tokenization.py:84-96 via CLIPProcessor).
    """

    def __init__(self, vocab_file: str, merges_file: str, max_len: int = 77):
        import json as _json

        import regex as re

        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = _json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.unk_token = "<|endoftext|>"
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token_id = self.eos_token_id
        self.max_len = max_len
        self.nlp = BasicTokenizer(strip_accents=False, do_split_on_punc=False)
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        text = " ".join(self.nlp.tokenize(text))
        out: list[str] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.bpe(token).split(" "))
        return out

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        unk = self.encoder[self.unk_token]
        return [self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str, truncation: bool = True, max_length: int | None = None) -> list[int]:
        max_length = max_length or self.max_len
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, texts, padding: str = "longest", truncation: bool = True,
                 max_length: int | None = None) -> Encoding:
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t, truncation=truncation, max_length=max_length) for t in texts]
        L = max_length if padding == "max_length" else max(len(s) for s in seqs)
        ids = np.full((len(seqs), L), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s[:L]
            mask[i, : len(s)] = 1
        return Encoding(input_ids=ids, attention_mask=mask)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token_id, self.eos_token_id}
        toks = [self.decoder[int(i)] for i in np.asarray(ids).tolist()
                if not (skip_special_tokens and int(i) in specials)]
        text = "".join(toks)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def trimmed_pad_len(attention_mask, cap: int = 35, mult: int = 8) -> int:
    """Effective padded length for a tokenized batch: the true max token
    count rounded up to ``mult``, clamped to the reference's fixed pad
    ``cap``. Shared by the ITM-text trims (visual tokenization rerank,
    retrieval-eval rerank): masked pad positions contribute exactly 0 to
    attention (their -1e4 additive bias underflows exp() in fp32), so
    slicing ids/atts to this length is bitwise-neutral while the
    per-row text-side FLOPs drop ~cap/L."""
    import numpy as np

    L = int(np.asarray(attention_mask).sum(axis=1).max())
    return min(cap, max(mult, ((L + mult - 1) // mult) * mult))


def write_test_clip_bpe(vocab_path: str, merges_path: str, words: list[str]) -> None:
    """Build a tiny CLIP-style vocab.json + merges.txt covering `words`:
    every byte-char and byte-char+'</w>' is in the vocab, plus whole-word
    merges for the given words. For tests and toy runs."""
    import json as _json

    chars = sorted(set(bytes_to_unicode().values()))
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = ["#version: 0.2"]
    for w in words:
        w = w.lower()
        if len(w) < 2:
            continue
        # merge left-to-right: (a b), (ab c), ... final token w</w>
        prefix = w[0]
        for i, ch in enumerate(w[1:], start=1):
            is_last = i == len(w) - 1
            right = ch + "</w>" if is_last else ch
            merges.append(f"{prefix} {right}")
            prefix = prefix + ch
            tok = prefix + ("</w>" if is_last else "")
            if tok not in vocab:
                vocab[tok] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(vocab_path, "w", encoding="utf-8") as f:
        _json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")


def write_test_vocab(path: str, words: list[str]) -> None:
    """Build a tiny bert-style vocab.txt: 5 special tokens at the canonical
    positions + words/wordpieces. For tests and toy runs."""
    base = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen = set(base)
    out = list(base)
    for w in words:
        if w not in seen:
            out.append(w)
            seen.add(w)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")


def write_bench_vocab(path: str) -> None:
    """Full-size (30524 with [DEC]/[ENC]) RETOK-STABLE synthetic vocab for
    throughput benches of the CapFilt path with random weights.

    Differs from the canonical layout in two load-bearing ways:
    * ids 1-99 are plain words, not [unusedN] — a random-weight decoder
      generates low ids freely, and "[unusedN]" does not survive
      decode->tokenize (BasicTokenizer splits the brackets), which would
      force the fused filter's verification into permanent fallback;
    * the CapFilt prompt words "a picture of" are real entries — as
      [UNK]s they are dropped by decode and the prompt-strip then eats
      13 chars of caption, another permanent-fallback trap.
    A real BLIP checkpoint emits natural words (retok-stable), so this
    layout is the representative one for benching; vocab size matches
    bert-base-uncased + BLIP specials.
    """
    base = (["[PAD]", "a", "picture", "of"] + [f"word{i}" for i in range(96)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(base + [f"tok{i}" for i in range(30418)]) + "\n")


MPNET_VOCAB_SIZE = 30527


def write_mpnet_vocab(path: str) -> None:
    """Full-width (30527) synthetic SBERT vocab.txt in all-mpnet-base-v2's
    layout: ``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, then
    bert-base-uncased's 30522 slots shifted by 4 (``[PAD]`` 4, ``[UNK]``
    104, ``[CLS]`` 105, ``[SEP]`` 106, ``[MASK]`` 107) with a plain word
    ``word{i}`` in every other slot, then ``<mask>`` 30526. The pad id 1 is
    load-bearing: it anchors MPNet's RoBERTa-style position ids."""
    bert = (["[PAD]"] + [f"word{i}" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + [f"word{i}" for i in range(99, 30418 + 99)])
    tokens = ["<s>", "<pad>", "</s>", "<unk>"] + bert + ["<mask>"]
    assert len(tokens) == MPNET_VOCAB_SIZE
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
