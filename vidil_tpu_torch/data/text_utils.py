"""Caption and question preprocessing, the per-rank result merge and the
file-lock poll: the port's own copy of ``vidil_tpu/data/text_utils.py``
(`is_locked`, `wait_for_file`, `pre_caption`, `pre_caption_minimum`,
`pre_question`, `save_result`), byte-identical to the reference's
(reference: data/utils.py:13-123).
"""

from __future__ import annotations

import os
import re
import time

from vidil_tpu_torch.utils.dist import barrier, get_rank, get_world_size, is_main_process
from vidil_tpu_torch.utils.io import load_json, save_json


def is_locked(filepath: str) -> bool:
    """True while another process holds the file open exclusively — the
    reference's only concurrency guard for multi-process reads of one file
    (reference: data/utils.py:13-26)."""
    locked = None
    if os.path.exists(filepath):
        try:
            with open(filepath, "r+"):
                locked = False
        except IOError:
            locked = True
    return bool(locked)


def wait_for_file(filepath: str, wait_time: float = 1.0, max_wait: float = 60.0) -> bool:
    """Poll until the file is readable (reference: data/utils.py:28-33)."""
    waited = 0.0
    while is_locked(filepath):
        time.sleep(wait_time)
        waited += wait_time
        if waited >= max_wait:
            return False
    return os.path.exists(filepath)


def pre_caption(caption: str, max_words: int = 50) -> str:
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n")
    caption = caption.strip(" ")
    caption_words = caption.split(" ")
    if len(caption_words) > max_words:
        caption = " ".join(caption_words[:max_words])
    return caption


def pre_caption_minimum(caption: str, max_words: int = 50) -> str:
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
