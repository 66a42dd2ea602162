"""`CapFiltEngine.complete_chunk` under every branch of the CapFilt keys
(caption, filter, filter_generated_only, keep_original_caption): each
`CapFiltResult` field equal to the JAX engine's on the same chunk and the
same tiny fp32 weights, with original captions that hold several
sentences, newlines, abbreviations and pieces of at most 3 characters.
Under a profiler the original captions' split (`capfilt.split`) runs once a
video where their sentences are used (kept, or nothing generated) and not
at all where they are not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from vidil_tpu.config import MedConfig as JMed, ViTConfig as JViT
from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import convert
from vidil_tpu_torch.utils import profiling

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=64, encoder_width=32)
ENGINE_KW = dict(num_beams=3, max_length=12, min_length=3)
V, F = 3, 2
ORIGINALS = [
    ["A man runs on the beach. Then he sits.\nDr. Smith waves at the camera!",
     "ok. a dog plays with a red ball... It jumps. no"],
    ["Mr. J. Smith sings e.g. a song at 3.5 p.m. today.\nhi\nThe cat sits on a tree.",
     "a car on the street"],
    ["walks. runs. the man eats food!? yes.\n\nA big house, etc. and a small one."],
]
# the tiny filterer's probabilities lie within 0.5189-0.5197: this threshold
# sits in their widest gap (1e-4 on each side), so the filter keeps some
# texts and drops others
BASE = {"caption": True, "filter": True, "filter_generated_only": True,
        "keep_original_caption": False, "filter_mode": "max_filter", "threshold": 0.51933,
        "generation_mode": "beam", "do_sentence_tokenization": True}
# name: (changed keys, originals used)
BRANCHES = {
    "no_caption": (dict(caption=False), True),
    "keep_original_generated_only": (dict(keep_original_caption=True), True),
    "keep_original_all": (dict(keep_original_caption=True, filter_generated_only=False), True),
    "generated_only": ({}, False),
    "all": (dict(filter_generated_only=False), False),
    "all_mean_filter": (dict(filter_generated_only=False, keep_original_caption=True,
                             filter_mode="mean_filter"), True),
    "no_filter": (dict(filter=False), False),
    "no_filter_keep_original": (dict(filter=False, keep_original_caption=True), True),
    "no_caption_no_sentence_tokenization": (
        dict(caption=False, do_sentence_tokenization=False), True),
}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX CapFilt engine and the port's on the same init, fp32."""
    from vidil_tpu.models.blip import init_blip_decoder, init_blip_itm
    from vidil_tpu.pipeline.capfilt import CapFiltEngine as JEngine
    from vidil_tpu.tokenizer import BlipTokenizer as JTok, write_test_vocab
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer

    words = ["a", "picture", "of", "man", "dog", "cat", "runs", "plays", "beach", "park",
             "the", "on", "in", "ball", "red", "blue", "walks", "jumps", "sits", "tree",
             "car", "street", "house", "big", "small", "eats", "food"]
    vocab = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    write_test_vocab(vocab, words)
    jv, jm = JViT(**VIT_KW), JMed(**dict(MED_KW, vocab_size=JTok(vocab).vocab_size))
    cap = jax.tree_util.tree_map(np.asarray, init_blip_decoder(jax.random.PRNGKey(0), jv, jm))
    fil = jax.tree_util.tree_map(np.asarray, init_blip_itm(jax.random.PRNGKey(1), jv, jm))
    jeng = JEngine(cap, fil, JTok(vocab), jv, jm, dtype=None, **ENGINE_KW)
    peng = CapFiltEngine(convert.from_jax_params(cap), convert.from_jax_params(fil),
                         BlipTokenizer(vocab), ViTConfig(**VIT_KW),
                         MedConfig(**dict(MED_KW, vocab_size=jm.vocab_size)),
                         dtype=torch.float32, device="cpu", **ENGINE_KW)
    return jeng, peng


def _chunk():
    rng = np.random.RandomState(7)
    return [{"video_id": f"v{v}", "frames": rng.randint(0, 256, (F, 32, 32, 3), np.uint8),
             "text": list(ORIGINALS[v])} for v in range(V)]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_complete_chunk_equals_jax_and_splits_only_used_originals(engines, branch):
    jeng, peng = engines
    changed, originals_used = BRANCHES[branch]
    config = dict(BASE, **changed)
    want = jeng.run_chunk(_chunk(), config)
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = peng.complete_chunk(peng.dispatch_chunk(_chunk(), config))
        calls = {k: c for k, (c, _) in profiling.span_totals().items()}
    finally:
        profiling.reset_spans()
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert calls["capfilt.complete"] == calls["capfilt.sentences"] == 1
    assert calls.get("capfilt.split", 0) == (V if originals_used else 0)
    if not config["caption"] and config["do_sentence_tokenization"]:
        # the chunk's captions reach the splitter's cases: an abbreviation
        # held inside a sentence, pieces of at most 3 characters dropped
        sentences = sum((r.unfiltered_text for r in got), [])
        assert "Dr. Smith waves at the camera!" in sentences
        assert not {"ok.", "no", "hi", "yes."} & set(sentences)
    if branch == "keep_original_all":
        assert 0 < sum(len(r.text) for r in got) < sum(len(r.unfiltered_text) for r in got)
