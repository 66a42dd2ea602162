"""VLEP evaluation: map predictions to the nearer of the two candidate
events by sentence-embedding cosine; emit CodaLab submission jsonl.

Reference: eval_vlep.py:15-71. The port's own copy of
``vidil_tpu/evals/vlep.py``; its default encoder is ``evals/qa.py``'s
(the local MPNet snapshot that ``VIDIL_SBERT_MODEL`` names).
"""

from __future__ import annotations

import json

import numpy as np

from vidil_tpu_torch.evals.qa import _default_encoder


def _nearest_event(encoder, result: str, candidates: list[str]) -> int:
    cand = np.asarray(encoder(candidates))
    pred = np.asarray(encoder([result]))
    cand = cand / np.linalg.norm(cand, axis=-1, keepdims=True)
    pred = pred / np.linalg.norm(pred, axis=-1, keepdims=True)
    return int(np.argmax((pred @ cand.T)[0]))


def _write_lines(output_lines, output_path):
    with open(output_path, "w") as out:
        for line in output_lines:
            out.write(json.dumps(line))
            out.write("\n")


def eval_openended(results, example_id_2_data, output_path, encoder=None):
    """Open-ended predictions keyed by VIDEO id (reference :15-38)."""
    encoder = encoder or _default_encoder()
    output_lines = []
    for example_id, ann in example_id_2_data.items():
        video_id = ann["video_id"]
        if video_id in results:
            result = results[video_id]
            if isinstance(result, list):
                result = result[0]
            top = _nearest_event(encoder, result, ann["events"])
            assert top in (0, 1)
            output_lines.append({"example_id": int(example_id), "pred_ans": top})
    print(len(output_lines))
    _write_lines(output_lines, output_path)
    return output_lines


def eval_multichoice(results, example_id_2_data, output_path, encoder=None):
    """Multichoice predictions keyed by EXAMPLE id (reference :40-63)."""
    encoder = encoder or _default_encoder()
    output_lines = []
    for example_id, ann in example_id_2_data.items():
        if example_id in results:
            result = results[example_id]
            if isinstance(result, list):
                result = result[0]
            top = _nearest_event(encoder, result, ann["events"])
            assert top in (0, 1)
            output_lines.append({"example_id": int(example_id), "pred_ans": top})
    _write_lines(output_lines, output_path)
    return output_lines


def vlep_accuracy(pred_lines, example_id_2_data) -> float:
    """Dev-set accuracy when gt answers are available (answer field is the
    index of the correct event)."""
    correct = total = 0
    for line in pred_lines:
        ann = example_id_2_data.get(str(line["example_id"])) or example_id_2_data.get(line["example_id"])
        if ann is None or "answer" not in ann:
            continue
        total += 1
        correct += int(line["pred_ans"] == int(ann["answer"]))
    return correct / max(total, 1)
