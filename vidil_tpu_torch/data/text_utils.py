"""Caption and question preprocessing and the per-rank result merge: the
port's own copy of ``vidil_tpu/data/text_utils.py`` (`pre_caption`,
`pre_question`, `save_result`), byte-identical to the reference's
(reference: data/utils.py:35-123).
"""

from __future__ import annotations

import os
import re

from vidil_tpu_torch.utils.dist import barrier, get_rank, get_world_size, is_main_process
from vidil_tpu_torch.utils.io import load_json, save_json


def pre_caption(caption: str, max_words: int = 50) -> str:
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n")
    caption = caption.strip(" ")
    caption_words = caption.split(" ")
    if len(caption_words) > max_words:
        caption = " ".join(caption_words[:max_words])
    return caption


def pre_question(question: str, max_ques_words: int = 50) -> str:
    question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
    question = question.rstrip(" ")
    question_words = question.split(" ")
    if len(question_words) > max_ques_words:
        question = " ".join(question_words[:max_ques_words])
    return question


def save_result(result: list, result_dir: str, filename: str,
                remove_duplicate: str = "") -> str:
    """Per-rank json + barrier + rank-0 merge with dedup
    (reference: data/utils.py:94-123)."""
    result_file = os.path.join(result_dir, "%s_rank%d.json" % (filename, get_rank()))
    final_result_file = os.path.join(result_dir, "%s.json" % filename)
    save_json(result_file, result, indent=None)
    barrier()
    if is_main_process():
        result = []
        for rank in range(get_world_size()):
            result += load_json(os.path.join(result_dir, "%s_rank%d.json" % (filename, rank)))
        if remove_duplicate:
            result_new, id_list = [], []
            for res in result:
                if res[remove_duplicate] not in id_list:
                    id_list.append(res[remove_duplicate])
                    result_new.append(res)
            result = result_new
        save_json(final_result_file, result, indent=None)
        print("result file saved to %s" % final_result_file)
    return final_result_file
