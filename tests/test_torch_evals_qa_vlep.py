"""The port's QA and VLEP evals (vidil_tpu_torch/evals/{qa,vlep}.py) against
the JAX package's on the fixtures of tests/test_qa_reference_oracle.py and
tests/test_evals.py: the text clean-up, GPT-3 jsonl processing, ranking
and generation accuracies (answer mapping by cosine, majority vote) and the
VLEP submissions, with tests/test_evals.py's fake encoder and with each
package's fp32 SBERT encoder of one tiny MPNet snapshot. Accuracies are
equal and written lines identical.
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

from test_evals import fake_encoder
from test_qa_reference_oracle import CASES
from test_torch_mpnet import jax_encoder, write_tiny_snapshot
from vidil_tpu.evals import qa as jqa
from vidil_tpu.evals import vlep as jvlep
from vidil_tpu_torch.evals import qa as pqa
from vidil_tpu_torch.evals import vlep as pvlep
from vidil_tpu_torch.pipeline.generate_prompts import make_sbert_encoder

torch.set_num_threads(1)


@pytest.mark.parametrize("s", CASES)
@pytest.mark.parametrize("fsr", [False, True])
@pytest.mark.parametrize("tfs", [False, True])
def test_clean_text_qa_matches_jax(s, fsr, tfs):
    assert pqa.clean_text_qa(s, filter_short_response=fsr, take_first_sentence=tfs) == \
        jqa.clean_text_qa(s, filter_short_response=fsr, take_first_sentence=tfs)


def test_clean_text_fuzz_and_post_processing_match_jax():
    words = ["a", "the", "dog", "cat", ".", ",", "spam", "Objects:", "Frame",
             "\n\nObjects:", "\n\nFrame", "no", "answer", "\n", "  "]
    rng = random.Random(13)
    for _ in range(400):
        s = " ".join(rng.choice(words) for _ in range(rng.randint(0, 20)))
        for fsr in (False, True):
            assert pqa.clean_text_qa(s, filter_short_response=fsr) == \
                jqa.clean_text_qa(s, filter_short_response=fsr), repr(s)
    for q, a in [("what is the man doing?", "I'm not sure"), ("who is in the video?", "not sure"),
                 ("what color is it?", "There is no answer"), ("who is this?", "There is no one"),
                 ("what is the man doing?", "playing guitar"), ("doing? who", "not sure")]:
        assert pqa.question_aware_post_processing(q, a) == jqa.question_aware_post_processing(q, a)


ANSWERS = ["dog", "cat", "beach", "park", "man", "guitar", "red", "running"]
# (question, gt answer, video) lines, tests/test_evals.py's first three first
GT = [("what is it?", "dog", "v1"), ("who?", "cat", "v1"), ("where?", "beach", "v2"),
      ("what is the man doing?", "running", "v2"), ("what does he play?", "guitar", "v3"),
      ("what color?", "red", "v3"), ("who is there?", "man", "v4")]
# three sampled GPT-3 answers per question: exact, near and off the list
SAMPLES = [["dog.", "a dog. more", "the dog"], ["cat. and more", "a cat", "cat"],
           ["beach", "on the beach", "park"], ["not sure", "running", "a man running"],
           ["guitar", "he plays guitar", "a red guitar"], ["red", "red.", "the red one"],
           ["There is no one", "a man", "man"]]


@pytest.fixture(scope="module")
def qa_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qa")
    with open(d / "gt.jsonl", "w") as f:
        for q, a, vid in GT:
            f.write(json.dumps({"question": q, "answer": a, "video_id": vid}) + "\n")
    with open(d / "raw.jsonl", "w") as f:
        for samples in SAMPLES:
            f.write(json.dumps({"choices": [{"text": s} for s in samples]}) + "\n")
    json.dump(ANSWERS, open(d / "answers.json", "w"))
    qidx = {}
    idx = {}
    for i, (_, _, vid) in enumerate(GT):
        idx[str(i)] = [vid, qidx.setdefault(vid, 0)]
        qidx[vid] += 1
    json.dump(idx, open(d / "idx.json", "w"))
    json.dump([{"question_id": i, "answer": s[1]} for i, s in enumerate(SAMPLES)],
              open(d / "pred.json", "w"))
    return d


@pytest.fixture(scope="module")
def sbert(tmp_path_factory):
    words = sorted({w.strip(".") for s in SAMPLES for x in s for w in x.lower().split()}
                   | set(ANSWERS) | {".", "the", "a"})
    root = write_tiny_snapshot(tmp_path_factory.mktemp("sbert"), words, seed=5)
    return {"jax": jax_encoder(root, jnp.float32),
            "port": make_sbert_encoder(root, device="cpu", dtype=torch.float32)}


def _encoders(kind, sbert):
    return (fake_encoder, fake_encoder) if kind == "fake" else (sbert["jax"], sbert["port"])


def test_ranking_and_gpt3_jsonl_processing_match_jax(qa_files, tmp_path):
    preds = [{"question_id": 0, "answer": "dog"}, {"question_id": 1, "answer": "cat"},
             {"question_id": 2, "answer": "park"}]
    acc = pqa.evaluate_ranking_result(preds, str(qa_files / "gt.jsonl"))
    assert acc == jqa.evaluate_ranking_result(preds, str(qa_files / "gt.jsonl"))
    assert abs(acc - 2 / 3) < 1e-9
    assert pqa.evaluate_ranking_result(str(qa_files / "pred.json"), str(qa_files / "gt.jsonl")) \
        == jqa.evaluate_ranking_result(str(qa_files / "pred.json"), str(qa_files / "gt.jsonl"))
    out = []
    for name, mod in (("jax", jqa), ("port", pqa)):
        d = tmp_path / name
        d.mkdir()
        path = mod.process_gpt3_response_jsonl(str(qa_files / "raw.jsonl"), str(d))
        assert path == str(d / "tmp.jsonl")
        out.append((d / "tmp.jsonl").read_bytes())
    assert out[1] == out[0]


@pytest.mark.parametrize("kind", ["fake", "sbert"])
def test_generation_accuracies_match_jax(qa_files, tmp_path, sbert, kind):
    jenc, penc = _encoders(kind, sbert)
    gt, answers = str(qa_files / "gt.jsonl"), str(qa_files / "answers.json")
    idx = json.load(open(qa_files / "idx.json"))
    tmp = pqa.process_gpt3_response_jsonl(str(qa_files / "raw.jsonl"), str(tmp_path))
    accs = []
    for mod, enc in ((jqa, jenc), (pqa, penc)):
        accs.append((
            mod.evaluate_generation_result(str(qa_files / "pred.json"), gt, answers, encoder=enc),
            mod.evaluate_generation_result_jsonl(tmp, gt, answers, idx, encoder=enc),
            mod.evaluate_generation_result_jsonl(tmp, gt, ANSWERS, idx, post_processing=True,
                                                 encoder=enc),
            mod.evaluate_generation_result_jsonl_majority_vote(tmp, gt, answers, idx,
                                                               encoder=enc),
            mod.evaluate_generation_result_jsonl_majority_vote(tmp, gt, answers, idx,
                                                               post_processing=True,
                                                               encoder=enc)))
    assert accs[1] == accs[0]
    # the answer mapping itself, row by row
    texts = [s for samples in SAMPLES for s in samples]
    a_emb = [np.asarray(enc(ANSWERS)) for enc in (jenc, penc)]
    np.testing.assert_array_equal(pqa._cosine_argmax(penc, texts, a_emb[1]),
                                  jqa._cosine_argmax(jenc, texts, a_emb[0]))


VLEP_DATA = {
    "0": {"video_id": "v1", "events": ["the dog barks", "the cat leaves"], "answer": 0},
    "1": {"video_id": "v2", "events": ["he falls", "he jumps"], "answer": 1},
    "2": {"video_id": "v3", "events": ["a man plays guitar", "a man runs"], "answer": 1},
    "3": {"video_id": "v4", "events": ["the red car stops", "the dog runs"]},
}


@pytest.mark.parametrize("kind", ["fake", "sbert"])
def test_vlep_submissions_match_jax(tmp_path, sbert, kind):
    jenc, penc = _encoders(kind, sbert)
    multi = {"0": "the dog barks", "1": ["he jumps", "x"], "2": "a man running", "3": "dog"}
    openended = {"v1": "a cat leaves", "v2": ["he falls down"], "v3": "guitar", "v9": "none"}
    out = []
    for name, mod, enc in (("jax", jvlep, jenc), ("port", pvlep, penc)):
        lines_m = mod.eval_multichoice(multi, VLEP_DATA, str(tmp_path / f"{name}_m.jsonl"),
                                       encoder=enc)
        lines_o = mod.eval_openended(openended, VLEP_DATA, str(tmp_path / f"{name}_o.jsonl"),
                                     encoder=enc)
        out.append((lines_m, lines_o, mod.vlep_accuracy(lines_m, VLEP_DATA),
                    mod.vlep_accuracy(lines_o, VLEP_DATA),
                    (tmp_path / f"{name}_m.jsonl").read_bytes(),
                    (tmp_path / f"{name}_o.jsonl").read_bytes()))
    assert out[1] == out[0]
    assert [line["example_id"] for line in out[1][0]] == [0, 1, 2, 3]
