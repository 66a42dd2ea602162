"""Video QA evaluation: SBERT answer mapping to the closed answer list.

Reference: eval_video_qa_result.py — ranking accuracy, open-ended
generation accuracy via nearest-answer cosine mapping, GPT-3 raw jsonl
variants, majority vote over sampled generations, and the
question-aware post-processing heuristic.

The port's own copy of ``vidil_tpu/evals/qa.py``. The sentence encoder
is injectable (``encoder: list[str] -> (n, d)``); the default is the
port's MPNet read from the local snapshot directory that
``VIDIL_SBERT_MODEL`` names (the reference's
SentenceTransformer('all-mpnet-base-v2'), with no download route), on
CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

from vidil_tpu_torch.pipeline.gpt3 import load_jsonl


def load_jsonl_gt(path: str) -> list:
    lines = []
    with open(path) as f:
        for line in f:
            obj = json.loads(line)
            obj["question_id"] = len(lines)
            lines.append(obj)
    return lines


def clean_text_qa(text: str, filter_short_response: bool = False,
                  take_first_sentence: bool = True):
    """reference :45-70 — QA variant keeps only the first sentence."""
    text = text.strip()
    if "\n\nObjects:" in text:
        text = text.split("\n\nObjects:")[0]
    elif "\n\nFrame" in text:
        text = text.split("\n\nFrame")[0]
    if take_first_sentence:
        text = text.split(".")[0].strip()
    if filter_short_response:
        counts = defaultdict(int)
        for tok in text.split(" "):
            counts[tok] += 1
        for key, value in counts.items():
            if value >= 8 and key not in [".", ",", "a", "the", "an"]:
                print("discard:", key, " | ", text)
                return None
    return text.lstrip("\n").lstrip().strip()


def process_gpt3_response_jsonl(response_jsonl_path: str, output_dir: str) -> str:
    """reference :72-91 — raw responses -> per-line {'samples': [...]}."""
    responses = load_jsonl(response_jsonl_path)
    lines = [{"samples": [clean_text_qa(it["text"]) for it in r["choices"]]} for r in responses]
    assert len(lines) == len(responses)
    output_path = os.path.join(output_dir, "tmp.jsonl")
    with open(output_path, "w") as out:
        for line in lines:
            out.write(json.dumps(line))
            out.write("\n")
    print("output processed file:", output_path)
    return output_path


def question_aware_post_processing(question_str: str, answer_str: str) -> str:
    """reference :143-153."""
    if "not sure" in answer_str or "There is no" in answer_str:
        if "doing?" in question_str:
            return "talk"
        if "who" in question_str:
            return "person"
    return answer_str


def _default_encoder(device="cuda"):
    """The SBERT encoder of the local MPNet snapshot that
    ``VIDIL_SBERT_MODEL`` names; a model name (the default
    'all-mpnet-base-v2') raises."""
    from vidil_tpu_torch.pipeline.generate_prompts import make_sbert_encoder

    return make_sbert_encoder(os.environ.get("VIDIL_SBERT_MODEL", "all-mpnet-base-v2"),
                              device=device)


def _cosine_argmax(encoder, texts: list[str], answer_embeddings: np.ndarray) -> np.ndarray:
    q = np.asarray(encoder(texts))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    a = answer_embeddings / np.linalg.norm(answer_embeddings, axis=-1, keepdims=True)
    return np.argmax(q @ a.T, axis=1)


def evaluate_ranking_result(prediction_json, groundtruth_jsonl) -> float:
    """Exact-match accuracy of ranked answers (reference :94-116)."""
    preds = json.load(open(prediction_json)) if isinstance(prediction_json, str) else prediction_json
    qid_2_pred = {item["question_id"]: item["answer"] for item in preds}
    gt = load_jsonl_gt(groundtruth_jsonl)
    qid_2_gt = {item["question_id"]: item["answer"] for item in gt}
    pairs = [(qid_2_gt[k], qid_2_pred[k]) for k in qid_2_gt if k in qid_2_pred]
    acc = float(np.mean([g == p for g, p in pairs])) if pairs else 0.0
    print(acc)
    return acc


def evaluate_generation_result(prediction_json, groundtruth_jsonl, answer_list_json,
                               encoder=None) -> float:
    """Open-ended answers mapped to the closed list by cosine (reference :157-215)."""
    encoder = encoder or _default_encoder()
    answer_list = json.load(open(answer_list_json)) if isinstance(answer_list_json, str) else answer_list_json
    answer_embeddings = np.asarray(encoder(answer_list))

    preds = json.load(open(prediction_json)) if isinstance(prediction_json, str) else prediction_json
    qids = [item["question_id"] for item in preds]
    answers = [item["answer"] for item in preds]
    top = _cosine_argmax(encoder, answers, answer_embeddings)
    qid_2_pred = {qid: answer_list[t] for qid, t in zip(qids, top)}

    gt = load_jsonl_gt(groundtruth_jsonl)
    qid_2_gt = {item["question_id"]: item["answer"] for item in gt}
    pairs = [(qid_2_gt[k], qid_2_pred[k]) for k in qid_2_gt if k in qid_2_pred]
    acc = float(np.mean([g == p for g, p in pairs])) if pairs else 0.0
    print(acc)
    return acc


def _gather_gpt3_qa(prediction_jsonl, groundtruth_jsonl, idx_2_video_id, take_all_samples: bool):
    gt = load_jsonl_gt(groundtruth_jsonl)
    video_id_to_gts = defaultdict(list)
    video_id_to_questions = defaultdict(list)
    for item in gt:
        video_id_to_gts[item["video_id"]].append(item["answer"])
        video_id_to_questions[item["video_id"]].append(item["question"])

    preds = load_jsonl(prediction_jsonl)
    video_id_to_answers = defaultdict(list)
    for i, item in enumerate(preds):
        video_id = idx_2_video_id[str(i)][0]
        if video_id in video_id_to_gts:
            video_id_to_answers[video_id].append(
                item["samples"] if take_all_samples else item["samples"][0]
            )
    return video_id_to_gts, video_id_to_questions, video_id_to_answers


def evaluate_generation_result_jsonl(prediction_jsonl, groundtruth_jsonl,
                                     answer_list_json, idx_2_video_id,
                                     post_processing: bool = False,
                                     encoder=None) -> float:
    """GPT-3 jsonl variant with idx->(video, qidx) remap (reference :217-290)."""
    encoder = encoder or _default_encoder()
    answer_list = json.load(open(answer_list_json)) if isinstance(answer_list_json, str) else answer_list_json
    answer_embeddings = np.asarray(encoder(answer_list))

    v2g, v2q, v2a = _gather_gpt3_qa(prediction_jsonl, groundtruth_jsonl, idx_2_video_id, False)

    gt_list, pred_answer_list = [], []
    for key in v2a.keys():
        assert len(v2g[key]) == len(v2a[key])
        for i in range(len(v2g[key])):
            gt_list.append(v2g[key][i])
            a = v2a[key][i]
            if post_processing:
                a = question_aware_post_processing(v2q[key][i], a)
            pred_answer_list.append(a)

    top = _cosine_argmax(encoder, pred_answer_list, answer_embeddings)
    pred_list = [answer_list[t] for t in top]
    acc = float(np.mean(np.asarray(pred_list) == np.asarray(gt_list)))
    print(acc)
    return acc


def evaluate_generation_result_jsonl_majority_vote(prediction_jsonl, groundtruth_jsonl,
                                                   answer_list_json, idx_2_video_id,
                                                   post_processing: bool = False,
                                                   encoder=None) -> float:
    """Majority vote over sampled generations (reference :292-362)."""
    encoder = encoder or _default_encoder()
    answer_list = json.load(open(answer_list_json)) if isinstance(answer_list_json, str) else answer_list_json
    answer_embeddings = np.asarray(encoder(answer_list))

    v2g, v2q, v2a = _gather_gpt3_qa(prediction_jsonl, groundtruth_jsonl, idx_2_video_id, True)

    gt_list, pred_answer_list = [], []
    for key in v2a.keys():
        assert len(v2g[key]) == len(v2a[key])
        for i in range(len(v2g[key])):
            gt_list.append(v2g[key][i])
            samples = v2a[key][i]
            if post_processing:
                samples = [question_aware_post_processing(v2q[key][i], s) for s in samples]
            pred_answer_list.append(samples)

    pred_list = []
    for samples in pred_answer_list:
        top = _cosine_argmax(encoder, samples, answer_embeddings)
        counts = defaultdict(int)
        for t in top:
            counts[answer_list[t]] += 1
        pred_list.append(sorted(counts.items(), key=lambda x: x[1], reverse=True)[0][0])

    acc = float(np.mean(np.asarray(pred_list) == np.asarray(gt_list)))
    print(acc)
    return acc
