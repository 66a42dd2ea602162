"""Video captioning evaluation: the port's own copy of
``vidil_tpu/evals/caption.py`` (reference:
eval_video_captioning_results.py, data/utils.py:175-221)."""

from __future__ import annotations

import json
import os
from collections import defaultdict

from vidil_tpu_torch.evals.caption_metrics import compute_caption_scores
from vidil_tpu_torch.pipeline.gpt3 import load_jsonl, process_gpt3_response


def video_caption_eval(gt_jsonl, results_file, output_path: str | None = None) -> dict:
    """gt_jsonl: path or list of {'caption', 'clip_name'} lines;
    results_file: path or list of {'video_id', 'caption'} (or a videoid-
    keyed dict). Scores only the common keys (reference :74-144)."""
    gt = load_jsonl(gt_jsonl) if isinstance(gt_jsonl, str) else gt_jsonl
    if isinstance(results_file, str):
        results = json.load(open(results_file))
        if not isinstance(results, list):
            results = [{"video_id": k, "caption": v} for k, v in results.items()]
    else:
        results = results_file

    gts_keys = {line["clip_name"] for line in gt}

    res: dict[str, list] = defaultdict(list)
    for item in results:
        if item["video_id"] not in gts_keys:
            continue
        cap = item["caption"]
        res[item["video_id"]].append(cap[0] if isinstance(cap, list) else cap)

    gts: dict[str, list] = defaultdict(list)
    for line in gt:
        if line["clip_name"] not in res:
            continue
        cap = line["caption"]
        gts[line["clip_name"]].extend(cap if isinstance(cap, list) else [cap])

    assert res.keys() == gts.keys()
    print(f"evaluate {len(res)} videos...")
    eval_dict = compute_caption_scores(gts, res)
    if eval_dict.get("METEOR") is None:
        # the reference reports Bleu/METEOR/ROUGE_L/CIDEr
        # (data/utils.py:205-216); exact METEOR needs pycocoevalcap's Java
        # jar + WordNet/paraphrase data, absent offline. The gap must be
        # loud in CLI output AND explicit (null) in written result files.
        print("WARNING: METEOR unavailable (pycocoevalcap/Java not installed); "
              "reported as null. Bleu/ROUGE_L/CIDEr use the golden-pinned "
              "pure-Python scorers; METEOR_approx is an exact+stem "
              "approximation (no WordNet stages), not comparable to jar "
              "METEOR.")
    print(eval_dict)
    if output_path:
        with open(output_path, "w") as out:
            json.dump(eval_dict, out, indent=4)
    return eval_dict


def eval_captioning_from_gpt3_response(gpt3_response_file, idx_2_videoid_json,
                                       gt_jsonl, output_dir) -> dict:
    """reference :146-159 — process the raw response then score it."""
    processed = os.path.join(output_dir, "processed_" + os.path.basename(gpt3_response_file)[:-1])
    metric_output_path = os.path.join(output_dir, "metric.json")
    process_gpt3_response(idx_2_videoid_json, gpt3_response_file, output_path=processed)
    return video_caption_eval(gt_jsonl, processed, output_path=metric_output_path)
