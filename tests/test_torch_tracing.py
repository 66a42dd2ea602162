"""The port's spans (`vidil_tpu_torch/utils/profiling.py:annotate`) on the
CPU: off without a profiler (the one shared no-op object, nothing
recorded); under `profiling.trace` every stage of a tiny CapFilt chunk, of
its decode (beam search and nucleus sampling) and of a caption train step,
with its count, inside its root in the registry and in the written Chrome
trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from vidil_tpu_torch.config import MedConfig, ViTConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.utils import profiling
from vidil_tpu_torch.utils.seeding import init_generator

torch.set_num_threads(1)

VIT_KW = dict(image_size=32, patch_size=16, hidden_size=32, num_layers=2, num_heads=4)
MED_KW = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
              max_position_embeddings=64, encoder_width=32)
MAX_LENGTH = 12
CONFIG = {"caption": True, "filter": True, "filter_generated_only": True,
          "keep_original_caption": False, "filter_mode": "max_filter", "threshold": 0.4,
          "generation_mode": "beam", "do_sentence_tokenization": True}
DISPATCH = {"capfilt.upload", "capfilt.encode", "capfilt.itm", "decode.prefill",
            "decode.select", "decode.reorder", "decode.step"}
COMPLETE = {"capfilt.wait", "capfilt.detokenize", "capfilt.sentences", "capfilt.filter_check"}
TRAIN = {"train.upload", "train.forward", "train.backward", "train.optimizer"}


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A tiny fp32 CapFilt engine on the init (seed 0 captioner, seed 1
    filterer): 3 beams, 12 tokens, fused filter."""
    from vidil_tpu_torch.pipeline.capfilt import CapFiltEngine
    from vidil_tpu_torch.tokenizer import BlipTokenizer, write_test_vocab

    words = ["a", "picture", "of", "man", "dog", "cat", "runs", "plays", "beach", "park",
             "the", "on", "in", "ball", "red", "blue", "walks", "jumps", "sits", "tree"]
    vocab = str(tmp_path_factory.mktemp("vocab") / "vocab.txt")
    write_test_vocab(vocab, words)
    med = MedConfig(**MED_KW, vocab_size=BlipTokenizer(vocab).vocab_size)
    cap = B.init_blip_decoder(init_generator(0), ViTConfig(**VIT_KW), med)
    fil = B.init_blip_itm(init_generator(1), ViTConfig(**VIT_KW), med)
    return CapFiltEngine(cap, fil, BlipTokenizer(vocab), ViTConfig(**VIT_KW), med,
                         num_beams=3, max_length=MAX_LENGTH, min_length=3,
                         dtype=torch.float32, device="cpu")


def _chunk(videos=2, frames=2):
    rng = np.random.RandomState(5)
    return [{"video_id": f"v{v}", "frames": rng.randint(0, 256, (frames, 32, 32, 3), np.uint8),
             "text": ["A man runs on the beach. Then he sits.", "a dog plays"]}
            for v in range(videos)]


def _trace_events(log_dir):
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and str(e.get("name")).startswith("vidil.")]


@pytest.fixture(scope="module")
def beam_chunk(engine, tmp_path_factory):
    """One beam chunk dispatched and completed under `profiling.trace`: the
    registry's totals and the trace's vidil.* ranges."""
    log_dir = str(tmp_path_factory.mktemp("beam_trace"))
    engine.complete_chunk(engine.dispatch_chunk(_chunk(), CONFIG))  # warm
    profiling.reset_spans()
    with profiling.trace(log_dir):
        results = engine.complete_chunk(engine.dispatch_chunk(_chunk(), CONFIG))
    totals = profiling.span_totals()
    profiling.reset_spans()
    return totals, _trace_events(log_dir), results


@pytest.fixture(scope="module")
def train_totals():
    """One tiny fp32 caption train step under a profiler: the registry."""
    from vidil_tpu_torch.train import caption as C

    med = MedConfig(**MED_KW, vocab_size=64)
    params = B.init_blip_decoder(init_generator(0), ViTConfig(**VIT_KW), med)
    state = C.create_caption_train_state(params, 1e-4, device="cpu")
    step = C.make_caption_train_step(ViTConfig(**VIT_KW), med, prompt_length=3)
    rng = np.random.RandomState(0)
    ids = rng.randint(6, 64, size=(2, 10)).astype(np.int32)
    ids[:, 0] = 1
    batch = {"video": rng.randn(2, 2, 32, 32, 3).astype(np.float32) * 0.1,
             "input_ids": ids, "attention_mask": np.ones((2, 10), np.int32)}
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, m = step(state, batch)
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    return totals


def test_span_without_a_profiler_is_the_shared_noop():
    a, b = profiling.annotate("capfilt.dispatch"), profiling.annotate("train.step")
    assert a is b
    with a:
        with b:
            torch.ones(4).sum()
    assert profiling.span_totals() == {}


def test_span_records_while_a_profiler_runs_and_stops_after():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        span = profiling.annotate("stage")
        assert span is not profiling.annotate("stage")
        with span:
            torch.ones(4).sum()
        with pytest.raises(ValueError), profiling.annotate("stage"):
            raise ValueError("raised inside a span")
    assert profiling.annotate("stage") is profiling.annotate("other")
    calls, seconds = profiling.span_totals()["stage"]
    assert calls == 2 and seconds > 0


def test_reset_spans_empties_the_registry():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("stage"):
            pass
    assert set(profiling.span_totals()) == {"stage"}
    profiling.reset_spans()
    assert profiling.span_totals() == {}


def test_beam_chunk_records_every_stage_with_its_count(engine, beam_chunk):
    """Every stage of a beam chunk on the CPU (no early readback there), one
    dispatch and one completion; the decode's select once a token after the
    prompt, its reorder and step once fewer; both encodes. The test
    vocabulary's [unusedN] words do not survive re-tokenization, so the
    fused filter re-scores the chunk's videos (``capfilt.fallback``)."""
    totals, _, results = beam_chunk
    assert len(results) == 2 and engine.fused_fallback_videos > 0
    assert set(totals) == ({"capfilt.dispatch", "capfilt.complete", "capfilt.fallback"}
                           | DISPATCH | COMPLETE)
    calls = {k: c for k, (c, _) in totals.items()}
    tokens = MAX_LENGTH - engine.prompt_length
    assert calls["capfilt.dispatch"] == calls["capfilt.complete"] == 1
    assert calls["decode.select"] == tokens
    assert calls["decode.reorder"] == calls["decode.step"] == tokens - 1
    assert calls["capfilt.encode"] == 2 and calls["decode.prefill"] == 2
    assert all(calls[k] == 1 for k in COMPLETE) and calls["capfilt.fallback"] == 1


def test_beam_chunk_ranges_lie_inside_their_root_in_the_trace(beam_chunk):
    totals, events, _ = beam_chunk
    names = {e["name"] for e in events}
    assert names == {profiling.SPAN_PREFIX + k for k in totals}
    roots = [e for e in events if e["name"] in ("vidil.capfilt.dispatch",
                                                "vidil.capfilt.complete")]
    assert len(roots) == 2
    for e in events:
        assert any(r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]
                   for r in roots), e["name"]


def test_nucleus_sampling_records_select_and_step(engine):
    sample = dict(CONFIG, generation_mode="sample")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.complete_chunk(engine.dispatch_chunk(
            _chunk(), sample, rng=torch.Generator().manual_seed(0)))
    calls = {k: c for k, (c, _) in profiling.span_totals().items()}
    tokens = MAX_LENGTH - engine.prompt_length
    assert calls["decode.select"] == tokens and calls["decode.step"] == tokens - 1
    assert calls["decode.prefill"] == 2 and "decode.reorder" not in calls


def test_train_step_records_its_stages(train_totals):
    """The step's root once, the upload, forward and backward once each,
    the optimizer twice (clearing the old gradients, then AdamW's step);
    no all-reduce without a process group."""
    calls = {k: c for k, (c, _) in train_totals.items()}
    assert set(calls) == {"train.step"} | TRAIN
    assert calls["train.step"] == 1 and calls["train.optimizer"] == 2
    assert all(calls[k] == 1 for k in TRAIN - {"train.optimizer"})


@pytest.mark.parametrize("root,children", [("capfilt.dispatch", DISPATCH),
                                           ("capfilt.complete", COMPLETE),
                                           ("train.step", TRAIN)])
def test_children_seconds_stay_within_their_root(beam_chunk, train_totals, root, children):
    """The direct children of a root do not overlap, so their seconds sum
    to at most the root's; the decode's parts sit inside the dispatch, the
    classic re-score inside the filter stage."""
    totals = beam_chunk[0] if root.startswith("capfilt") else train_totals
    assert 0 < sum(totals[k][1] for k in children) <= totals[root][1]
    if root == "capfilt.complete":
        assert totals["capfilt.fallback"][1] <= totals["capfilt.filter_check"][1]
