"""The port's prompt layer (vidil_tpu_torch/pipeline/{prompts,
generate_prompts,gpt3}.py) against the JAX package's on the fixtures of
tests/test_prompts.py, tests/test_prompt_prefix_reference_oracle.py and
tests/test_save_prompt_lines_reference_oracle.py: every prompt string,
jsonl line, idx map and chosen-samples file byte-identical, under the same
`random` seeds. In-context selection runs both packages' SBERT encoders
(fp32, one tiny MPNet snapshot) and must choose the same examples.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_prompt_prefix_reference_oracle import _config as prefix_config
from test_prompt_prefix_reference_oracle import _make_train_data
from test_prompts import FRAME_CAPTIONS, base_config, make_visual_tokens
from test_save_prompt_lines_reference_oracle import _cfg as lines_config
from test_save_prompt_lines_reference_oracle import _data as lines_data
from test_torch_mpnet import jax_encoder, write_tiny_snapshot
from vidil_tpu.pipeline import generate_prompts as jgp
from vidil_tpu.pipeline import gpt3 as jgpt3
from vidil_tpu.pipeline.prompts import Prompt as JPrompt
from vidil_tpu_torch.pipeline import generate_prompts as pgp
from vidil_tpu_torch.pipeline import gpt3 as pgpt3
from vidil_tpu_torch.pipeline.prompts import Prompt

torch.set_num_threads(1)


def _copy(x):
    return json.loads(json.dumps(x))


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("template", ["temporal_natural", "temporal_index", "static"])
@pytest.mark.parametrize("agg", ["v2", "v3"])
@pytest.mark.parametrize("task", ["caption", "qa", "vlep"])
@pytest.mark.parametrize("vid", ["vidA", "vidB", "vidC"])
def test_construct_prompt_matches_jax(template, agg, task, vid):
    vt = make_visual_tokens(seed=(len(template) * 31 + len(agg + task + vid)) % 1000)
    cfg = base_config(prompt_temporal_template=template,
                      visual_token_aggregation_version=agg, prompt_task=task)
    q = "what is happening?" if task == "qa" else None
    a = "a dog" if task == "qa" else None
    random.seed(7)
    want = JPrompt("Instruction line.\n\n", seed=7).construct_prompt(
        vid, _copy(vt), FRAME_CAPTIONS, cfg, q, a, asr="hello there.")
    random.seed(7)
    got = Prompt("Instruction line.\n\n", seed=7).construct_prompt(
        vid, _copy(vt), FRAME_CAPTIONS, cfg, q, a, asr="hello there.")
    assert got == want


def test_construct_prompt_fuzz_and_shuffle_match_jax():
    """tests/test_prompts.py's 200-config sweep (flags, topk, frame counts,
    list captions that Prompt shuffles with the seeded `random`), and the
    VLEP multichoice form."""
    rng = random.Random(4242)
    flags = ["add_objects", "add_events", "add_attributes", "add_scenes",
             "add_original_caption", "add_frame_captions", "add_ASR", "add_answer"]
    for i in range(200):
        cfg = base_config(
            prompt_temporal_template=rng.choice(["temporal_natural", "temporal_index", "static"]),
            visual_token_aggregation_version=rng.choice(["v2", "v3"]),
            prompt_task=rng.choice(["caption", "qa", "vlep"]), topk=rng.choice([1, 3, 4, 6]))
        for f in flags:
            cfg[f] = rng.random() < 0.5
        vid = rng.choice(list(FRAME_CAPTIONS))
        vt = make_visual_tokens(seed=i, num_frm=rng.choice([1, 4, 8]), caption=rng.choice(
            ["a ground truth caption", ["list cap one", "list cap two", "list cap three"]]))
        q, a = ("what is happening?", "a dog") if cfg["prompt_task"] == "qa" else (None, None)
        asr = rng.choice(["hello there.", "", None])
        out = []
        for cls in (JPrompt, Prompt):
            random.seed(1000 + i)
            out.append(cls("Instruction line.\n\n", seed=7).construct_prompt(
                vid, _copy(vt), FRAME_CAPTIONS, cfg, q, a, asr=asr))
        assert out[0] == out[1], (i, cfg)
    ex = {"events": ["the dog barks", "the cat leaves"], "answer": "A"}
    vt = make_visual_tokens(seed=5)
    cfg = base_config(prompt_task="vlep")
    assert Prompt("P.\n\n", seed=1).construct_prompt(
        "vidA", vt, FRAME_CAPTIONS, cfg, None, None, "some dialogue.", vlep_example=ex) == \
        JPrompt("P.\n\n", seed=1).construct_prompt(
            "vidA", vt, FRAME_CAPTIONS, cfg, None, None, "some dialogue.", vlep_example=ex)


def _prefix_both(tmp_path, tag, vt, filtered, unfiltered, ids, instr, task, permutate,
                 caption_all, qa, asr, shot, seed, **kw):
    out = {}
    for name, mod in (("jax", jgp), ("port", pgp)):
        d = tmp_path / f"{name}_{tag}"
        d.mkdir()
        res = mod.get_prompt_prefix(
            _copy(vt), filtered, unfiltered, ids, instr,
            prefix_config(task, permutate, str(d), caption_all=caption_all),
            qa, asr, shot=shot, seed=seed, **kw)
        out[name] = (res, _files(d))
    return out["jax"], out["port"]


@pytest.mark.parametrize("task", ["caption", "qa", "vlep"])
@pytest.mark.parametrize("permutate", [-1, 2])
@pytest.mark.parametrize("seed", [3, 11])
def test_get_prompt_prefix_matches_jax(tmp_path, task, permutate, seed):
    vt, filtered, unfiltered, ids, qa, asr = _make_train_data(random.Random(seed * 131), 8)
    for empty in ((), ("", " ")):
        want, got = _prefix_both(tmp_path, f"{len(empty)}", vt, filtered, unfiltered, ids,
                                 "Instruction.\n", task, permutate, True, qa, asr, 3, seed,
                                 asr_empty_values=empty)
        assert got == want


def test_get_prompt_prefix_fuzz_matches_jax(tmp_path):
    for i in range(25):
        rng = random.Random(9000 + i)
        vt, filtered, unfiltered, ids, qa, asr = _make_train_data(
            rng, rng.randint(4, 10), num_frm=rng.choice([1, 4]))
        task = rng.choice(["caption", "qa", "vlep"])
        shot = rng.randint(1, 3)
        want, got = _prefix_both(tmp_path, str(i), vt, filtered, unfiltered, ids, "Instr.\n",
                                 task, -1, rng.random() < 0.5, qa, asr, shot, i)
        assert got == want, (i, task, shot)


@pytest.mark.parametrize("kw", [dict(asr_empty_values=("",), vlep_truncate=False),
                                dict(asr_empty_values=(), vlep_truncate=True)],
                         ids=["fixed", "random"])
@pytest.mark.parametrize("task", ["caption", "qa", "vlep"])
@pytest.mark.parametrize("seed", [1, 5])
def test_save_prompt_lines_matches_jax(tmp_path, kw, task, seed):
    vt, filtered, unfiltered, qa, asr = lines_data(random.Random(seed * 977))
    files = []
    for name, mod, cls in (("jax", jgp, JPrompt), ("port", pgp, Prompt)):
        d = tmp_path / name
        d.mkdir()
        mod.save_prompt_lines(vt, filtered, unfiltered, cls("Instr.\n\n", seed=3),
                              lines_config(task, str(d)), qa, asr, **kw)
        files.append(_files(d))
    assert set(files[0]) == {"q.jsonl", "q__idx_2_videoid.json"}
    assert files[1] == files[0]


def _vlep_data(seed):
    """Example-id-keyed VLEP anns over tests/test_save_prompt_lines_
    reference_oracle.py's videos: train answers are event strings, target
    answers indices (tests/test_pipeline_full_chain.py's convention)."""
    rng = random.Random(seed)
    vt, filtered, unfiltered, _, asr = lines_data(rng)
    vids = sorted(vt)
    events = [["the dog runs", "the cat sits"], ["he jumps", "he falls, hard!"]]
    train = {f"ex{i}": {"video_id": rng.choice(vids), "events": events[i % 2],
                        "answer": events[i % 2][rng.randint(0, 1)]} for i in range(7)}
    target = {str(100 + i): {"video_id": v, "events": events[i % 2], "answer": i % 2}
              for i, v in enumerate(vids)}
    return vt, filtered, unfiltered, asr, train, target


@pytest.mark.parametrize("seed", [2, 8])
def test_vlep_prefix_and_lines_match_jax(tmp_path, seed):
    vt, filtered, unfiltered, asr, train, target = _vlep_data(seed)
    files = []
    for name, mod, cls in (("jax", jgp, JPrompt), ("port", pgp, Prompt)):
        d = tmp_path / name
        d.mkdir()
        cfg = lines_config("vlep", str(d))
        prefix = mod.get_prompt_prefix_vlep(vt, filtered, unfiltered, _copy(train),
                                            "Instruction: A or B?", cfg, asr, shot=3, seed=seed)
        cfg["add_original_caption"] = False
        mod.save_prompt_lines_vlep(_copy(target), vt, filtered, unfiltered,
                                   cls(prefix, seed=seed), cfg, asr)
        files.append(_files(d))
    assert set(files[0]) == {"q.jsonl", "q__idx_2_example_id.json", "q__chosen_samples.json"}
    assert files[1] == files[0]


def test_gpt3_processing_matches_jax(tmp_path):
    responses = [
        {"choices": [{"text": "\n a dog runs on the beach\n\nObjects: junk"}]},
        {"choices": [{"text": "cats sitting\n\nFrame Captions: junk"}, {"text": "  "}]},
        {"choices": [{"text": "spam " * 9}, {"text": "a man plays.\n\nFrame x"}]},
        {"choices": [{"text": "\n\n"}]},
    ]
    idx = {"0": "vidA", "1": "vidB", "2": ["vidC", 1], "3": "vidD"}
    json.dump(idx, open(tmp_path / "idx.json", "w"))
    with open(tmp_path / "resp.jsonl", "w") as f:
        for r in responses:
            f.write(json.dumps(r) + "\n")
    out = []
    for name, mod in (("jax", jgpt3), ("port", pgpt3)):
        d = tmp_path / name
        d.mkdir()
        processed = mod.process_gpt3_response(str(tmp_path / "idx.json"),
                                              str(tmp_path / "resp.jsonl"),
                                              str(d / "processed.json"))
        mod.video_level_only(processed, str(d / "pseudo"), selected_ids=None)
        mod.video_level_only(processed, str(d / "pseudo_sel"), selected_ids={"vidB"})
        out.append(((d / "processed.json").read_bytes(), _files(d / "pseudo"),
                    _files(d / "pseudo_sel")))
    assert out[1] == out[0]
    for text in ("\n\nhello world", "result\n\nObjects: a. b.", "cap\n\nFrame Captions: x",
                 "  padded  ", "a a a a a a a a a repeated", "x " * 9):
        for fsr in (False, True):
            assert pgpt3.clean_text(text, fsr) == jgpt3.clean_text(text, fsr)


# the words of the fixtures' prompts, so that the tiny MPNet sees them as
# tokens (unknown words would all embed as [UNK])
SNAPSHOT_WORDS = (
    ["first", "then", "after", "that", "finally", "frame", "captions", "cap", "gt", "video",
     "caption", "question", "answer", "q1", "q2", "a1", "a2", "what", "happens", "in", "who",
     "is", "a", "person", "sub", "one", "two", "longer", "subtitle", "x", "objects",
     "attributes", "scene", "events", "dog", "cat", "ball", "tree", "car", "red", "big",
     "shiny", "old", "beach", "park", "street", "running", "jumping", "sitting", ".", ",",
     "?", "!", ":"]
    + [f"vid{i}" for i in range(12)] + [str(i) for i in range(10)])


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return write_tiny_snapshot(tmp_path_factory.mktemp("sbert"), SNAPSHOT_WORDS, seed=3)


@pytest.mark.parametrize("task,target", [("caption", "caption"), ("qa", "question"),
                                         ("caption", "caption_asr")])
def test_in_context_selection_matches_jax_fp32(tmp_path, snapshot, task, target):
    """Support set from get_prompt_prefix, then per query the N nearest by
    each package's fp32 SBERT encoder of the same snapshot: the same jsonl,
    idx map and chosen samples, byte for byte."""
    encoders = {"jax": jax_encoder(snapshot, jnp.float32),
                "port": pgp.make_sbert_encoder(snapshot, device="cpu", dtype=torch.float32)}
    train = _make_train_data(random.Random(77), 8)
    vt, filtered, unfiltered, qa, asr = lines_data(random.Random(5))
    files = []
    for name, mod in (("jax", jgp), ("port", pgp)):
        d = tmp_path / name
        d.mkdir()
        cfg = lines_config(task, str(d))
        cfg.update(add_original_caption=True, add_answer=True, permutate=-1)
        tvt, tfil, tunf, ids, tqa, tasr = train
        _, examples, _ = mod.get_prompt_prefix(_copy(tvt), tfil, tunf, ids, "Instr.", cfg,
                                               tqa, tasr, shot=5, seed=42,
                                               asr_empty_values=("", " "))
        cfg.update(add_original_caption=False, add_answer=False)
        mod.save_prompt_lines_with_in_context_selection(
            vt, filtered, unfiltered, 3, "Instr.", examples, cfg, qa, asr,
            comparing_target=target, encoder=encoders[name])
        files.append(_files(d))
    assert set(files[0]) == {"q.jsonl", "q__idx_2_videoid.json", "q__chosen_samples.json"}
    assert files[1] == files[0]
    lines = [json.loads(line) for line in files[1]["q.jsonl"].decode().splitlines()]
    assert all(line["prompt"].startswith("Instr.") for line in lines)


def test_select_from_support_set_keeps_highest_at_the_bottom(snapshot):
    """The port's selection order against the JAX package's on one query
    with a fake encoder (a reversed ranking would pass the byte test only
    by luck)."""
    rng = np.random.RandomState(0)
    table = {}

    def enc(texts):
        return np.stack([table.setdefault(t, rng.randn(8).astype(np.float32)) for t in texts])

    examples = [f"Frame Captions: First, cap {i}.\nVideo Caption: c{i}" for i in range(6)]
    support = enc([e.split("Frame Captions: ")[1].split("\n")[0].strip() for e in examples])
    query = "Frame Captions: First, cap 9.\nVideo Caption:"
    got = pgp.select_from_support_set(enc, support, examples, query, N=4,
                                      comparing_target="caption")
    assert got == jgp.select_from_support_set(enc, support, examples, query, N=4,
                                              comparing_target="caption")
    q = enc(["First, cap 9."])[0]
    cos = [float(q @ s / np.linalg.norm(q) / np.linalg.norm(s)) for s in support]
    assert got[-1] == examples[int(np.argmax(cos))]
