"""VidIL's language-model stage on the card: the few-shot prompts that
`pipeline/generate_prompts.py` writes, answered by a hybrid language model
in the GPT-3 response shape that `pipeline/gpt3.py:process_gpt3_response`
reads. Two models run on it, picked by their config's ``model_type``
(`MODELS`): Nemotron-H (`models/nemotron_h.py`: Mamba-2, GQA attention and
relu^2 experts) and Kimi Linear (`models/kimi_linear.py`: KDA, latent
attention and SwiGLU experts, of which a config may hold a range, the
card's share of an expert-parallel deployment). Both keep the same cache
contract (`init_cache`, a packed `prefill` that fills row b with prompt b,
a one-token `step`).

`LMAnswerEngine` serves chunks of prompts as `pipeline/capfilt.py`'s
engine serves chunks of videos: `dispatch_chunk` tokenizes on the host,
uploads the packed prompts, runs the packed prefill into the hybrid cache
and enqueues the greedy decode (replayed from CUDA graphs, one set for each
batch size, `ops/decode_graph.py`), and returns without waiting for the
device; `complete_chunk` waits for the chunk's tokens and detokenizes
them. A caller keeps one chunk in flight by dispatching the next before
completing the last.

`WordTokenizer`: a whole-word vocabulary, one entry a line (``<nl>`` for
the line break): text splits into line breaks, runs of letters and digits,
and single punctuation marks, each one id (``<unk>`` when it has none). A
prompt starts with ``<s>``; an answer ends at ``</s>``.

Spans (`utils/profiling.py:annotate`): ``lm.dispatch`` (the whole
dispatch) holding ``lm.prefill`` and each decode step's ``lm.decode``
(inside one ``lm.graph`` when the decode is replayed from its graphs);
inside eager layers the model's mixers' spans (Nemotron-H: ``lm.mamba``,
``lm.attention``; Kimi Linear: ``lm.kda`` holding ``lm.kda_scan``,
``lm.mla``, ``lm.dense``) and ``lm.route`` and ``lm.experts``;
``lm.complete``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass

import numpy as np
import torch

from vidil_tpu_torch.models import kimi_linear, nemotron_h
from vidil_tpu_torch.ops import ssd
from vidil_tpu_torch.ops.decode_graph import DecodeGraphs, eager_piece, storage_key
from vidil_tpu_torch.ops.generation import greedy_search
from vidil_tpu_torch.utils.pinned import PinnedArena
from vidil_tpu_torch.utils.profiling import annotate

# each language model by its config's model_type: its module (init_cache,
# prefill, step) and its seeded initialisation
MODELS = {"nemotron_h": (nemotron_h, nemotron_h.init_nemotron_h),
          "kimi_linear": (kimi_linear, kimi_linear.init_kimi_linear)}

SPECIALS = ["<pad>", "<unk>", "<s>", "</s>", "<nl>"]
PAD, UNK, BOS, EOS, NL = range(5)
_PIECES = re.compile(r"\n|[^\W_]+|[^\w\s]|_")
_CLOSE = set(".,:;!?)]")
_OPEN = set("([")


class WordTokenizer:
    """Text <-> ids over a whole-word vocabulary (see the module's
    docstring); the first five entries are `SPECIALS`."""

    def __init__(self, vocab: list[str]):
        if vocab[: len(SPECIALS)] != SPECIALS:
            raise ValueError(f"a word vocabulary starts with {SPECIALS}")
        self.vocab = list(vocab)
        self.index = {w: i for i, w in enumerate(self.vocab)}

    @classmethod
    def from_file(cls, path: str) -> "WordTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(f.read().split("\n")[:-1])

    def encode(self, text: str) -> list[int]:
        """<s> and the ids of the text's pieces."""
        ids = [BOS]
        for piece in _PIECES.findall(text):
            ids.append(NL if piece == "\n" else self.index.get(piece, UNK))
        return ids

    def decode(self, ids) -> str:
        """The text of ids up to the first </s>, pads and <s> skipped."""
        out = []
        for i in ids:
            i = int(i)
            if i == EOS:
                break
            if i in (PAD, BOS) or not 0 <= i < len(self.vocab):
                continue
            word = "\n" if i == NL else self.vocab[i]
            if out and word != "\n" and out[-1] != "\n" and out[-1] not in _OPEN \
                    and word not in _CLOSE:
                out.append(" ")
            out.append(word)
        return "".join(out)


@dataclass
class LMChunk:
    """A dispatched chunk: its answer tokens on the device, the event
    recorded after them, and its prompt count."""

    tokens: torch.Tensor
    done: object
    n: int


class LMAnswerEngine:
    """Answers chunks of prompts (see the module's docstring): `cfg` a
    config of `MODELS`, `params` from its model's initialisation (or a
    checkpoint in its layout), prompts of at most `max_prompt_tokens` ids,
    `max_new_tokens` greedy tokens each."""

    def __init__(self, params, cfg, tokenizer: WordTokenizer, *, max_prompt_tokens: int,
                 max_new_tokens: int = 32, device=None):
        self.params = params
        self.cfg = cfg
        self.model = MODELS[cfg.model_type][0]
        self.tokenizer = tokenizer
        self.max_prompt_tokens = max_prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.device = torch.device(device) if device is not None else params["embed"].device
        self.capacity = max_prompt_tokens + max_new_tokens
        self.decode_graphs = DecodeGraphs(span="lm.graph")
        self._weights_key = storage_key(params)
        self._caches: dict = {}
        self._uploads = PinnedArena()
        self.probe = None  # a dict: the next dispatches record routes and logits, eagerly

    def cache(self, batch: int) -> dict:
        """The engine's hybrid cache for `batch` rows (made once)."""
        if batch not in self._caches:
            self._caches[batch] = self.model.init_cache(self.cfg, batch, self.capacity,
                                                        self.device,
                                                        self.params["embed"].dtype)
        return self._caches[batch]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return self._uploads.upload(a, self.device)

    def encode(self, prompts: list[str]):
        """The prompts' ids packed (T,) int64 and their `Packing`."""
        rows = [self.tokenizer.encode(p) for p in prompts]
        longest = max(len(r) for r in rows)
        if longest > self.max_prompt_tokens:
            raise ValueError(f"a prompt of {longest} tokens exceeds max_prompt_tokens "
                             f"{self.max_prompt_tokens}")
        return np.concatenate(rows).astype(np.int64), ssd.Packing(tuple(len(r) for r in rows))

    def _prefill(self, ids, packed, cache):
        return self.model.prefill(self.params, self.cfg, ids, packed, cache, self.probe)

    def _step(self, tokens, cache):
        logits = self.model.step(self.params, self.cfg, tokens, cache, self.probe)
        if self.probe is not None:
            self.probe.setdefault("logits", []).append(logits)
        return logits, cache

    def _decode(self, first_logits, cache):
        """The greedy tokens after the prefill: eager for a probe or off the
        card, else through the decode graphs (key: batch, capacity and the
        weights' storage), the cache handed in as the capture's inputs."""
        names = sorted(cache)

        def decode(first, *tensors, piece=eager_piece):
            c = dict(zip(names, tensors))
            return (greedy_search(first, c, self._step, self.max_new_tokens, EOS, PAD,
                                  piece=piece),)

        inputs = (first_logits, *(cache[n] for n in names))
        if self.probe is not None:
            self.probe.setdefault("logits", []).append(first_logits)
            return decode(*inputs)[0]
        key = ("lm", first_logits.shape[0], self.capacity, self._weights_key)
        return self.decode_graphs.run(key, decode, *inputs)[0]

    def dispatch_chunk(self, prompts: list[str]) -> LMChunk:
        with annotate("lm.dispatch"):
            ids, packing = self.encode(prompts)
            ids_dev = self._upload(ids)
            packed = ssd.pack(packing, self.cfg.chunk_size, self.device, self._upload)
            cache = self.cache(len(prompts))
            with annotate("lm.prefill"):
                first = self._prefill(ids_dev, packed, cache)
            tokens = self._decode(first, cache)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            return LMChunk(tokens, done, len(prompts))

    def complete_chunk(self, chunk: LMChunk) -> list[str]:
        """The chunk's answers, one string a prompt, in order."""
        with annotate("lm.complete"):
            if chunk.done is not None:
                chunk.done.synchronize()
            rows = chunk.tokens.cpu().numpy()
            return [self.tokenizer.decode(r) for r in rows]


def read_prompts(path: str) -> list[str]:
    """The prompts of a `generate_prompts` jsonl (GPT-3 request bodies), in
    line order."""
    with open(path) as f:
        return [json.loads(line)["prompt"] for line in f if line.strip()]


def write_responses(path: str, answers: list[str]) -> None:
    """One GPT-3 completion a line: ``{"choices": [{"text": answer}]}``."""
    with open(path, "w") as f:
        for a in answers:
            f.write(json.dumps({"choices": [{"text": a}]}) + "\n")


def answer_all(engine: LMAnswerEngine, prompts: list[str], batch: int) -> list[str]:
    """Every prompt answered, `batch` a chunk, one chunk in flight."""
    answers, inflight = [], None
    for i in range(0, len(prompts), batch):
        chunk = engine.dispatch_chunk(prompts[i:i + batch])
        if inflight is not None:
            answers += engine.complete_chunk(inflight)
        inflight = chunk
    if inflight is not None:
        answers += engine.complete_chunk(inflight)
    return answers
