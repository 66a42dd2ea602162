"""GPT-3 response post-processing (reference: utils_gpt3/): the port's own
copy of ``vidil_tpu/pipeline/gpt3.py``.

Converts raw GPT-3 completion jsonl + the __idx_2_videoid map back into
videoid-keyed caption jsons, and those into pseudo-label training jsonl
({'caption', 'clip_name', 'sen_id'} lines the retrieval/caption trainers
consume).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict


def load_jsonl(path: str) -> list:
    lines = []
    with open(path) as f:
        for line in f:
            lines.append(json.loads(line))
    return lines


def clean_text(text: str, filter_short_response: bool = False):
    """Strip trailing continuation blocks GPT-3 sometimes appends
    (reference: utils_gpt3/process_gpt3_response.py:15-35)."""
    text_ = text.strip()
    if "\n\nObjects:" in text_:
        text = text_.split("\n\nObjects:")[0]
    elif "\n\nFrame" in text_:
        text = text_.split("\n\nFrame")[0]

    if filter_short_response:
        token_counts = defaultdict(int)
        for tok in text.split(" "):
            token_counts[tok] += 1
        for key, value in token_counts.items():
            if value >= 8 and key not in [".", ",", "a", "the", "an"]:
                print("discard:", key, " | ", text)
                return None

    text = text.lstrip("\n")
    text = text.lstrip()
    return text.strip()


def process_gpt3_response(idx_2_videoid_path: str, response_jsonl_path: str,
                          output_path: str) -> str:
    """reference: utils_gpt3/process_gpt3_response.py:37-59."""
    idx_2_videoid = json.load(open(idx_2_videoid_path))
    responses = load_jsonl(response_jsonl_path)

    videoid_2_response: dict = {}
    for idx in range(len(responses)):
        video_id = idx_2_videoid[str(idx)]
        if isinstance(video_id, list):
            video_id = tuple(video_id)
        assert video_id not in videoid_2_response
        captions = []
        for item in responses[idx]["choices"]:
            cleaned = clean_text(item["text"])
            if cleaned:
                captions.append(cleaned)
        if captions:
            videoid_2_response[video_id] = captions

    # tuple keys (qa) are not json-serializable; stringify like the reference
    # never needs to (qa responses use a different eval path), so only plain
    # video-id keys are written here
    videoid_2_response = {
        (k if isinstance(k, str) else str(list(k))): v for k, v in videoid_2_response.items()
    }
    with open(output_path, "w") as out:
        json.dump(videoid_2_response, out, indent=4)
    print("output processed file:", output_path)
    return output_path


def video_level_only(input_path: str, output_dir: str, selected_ids=None) -> str:
    """Processed response json -> pseudo-label jsonl
    (reference: utils_gpt3/gpt3_response_to_jsonl.py:6-29)."""
    os.makedirs(output_dir, exist_ok=True)
    output_path = os.path.join(output_dir, f"{os.path.basename(input_path)[:-5]}.jsonl")

    data = json.load(open(input_path))
    if selected_ids is None:
        selected_ids = data.keys()
    lines = []
    for key, value in data.items():
        if key not in selected_ids:
            continue
        for i in range(len(value)):
            lines.append({"caption": value[i].strip(), "clip_name": key, "sen_id": len(lines)})
    print(len(lines))
    with open(output_path, "w") as out:
        for line in lines:
            out.write(json.dumps(line))
            out.write("\n")
    return output_path
