"""Prompt templating: visual tokens + frame captions -> GPT-3 prompt text.

The port's own copy of ``vidil_tpu/pipeline/prompts.py``, with the same
``random``/numpy seeding semantics: a string-identical re-implementation
of the reference prompt layer (reference:
visual_token_generation/prompts.py). Every template, section header,
separator and ordering rule is part of the output-file contract (the
generated jsonl feeds GPT-3 verbatim), so each piece is cited back to the
reference lines it must match.

Pure Python — no model dependencies.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict

import numpy as np


def _temporal_natural(x: list[str]) -> str:
    """'First, … Then, … Finally, …' (reference prompts.py:9-18)."""
    n = len(x)
    if n == 1:
        return f"First, {x[0]}."
    if n == 2:
        return f"First, {x[0]}. Then, {x[1]}."
    if n == 3:
        return f"First, {x[0]}. Then, {x[1]}. Finally, {x[2]}."
    if n == 4:
        return f"First, {x[0]}. Then, {x[1]}. After that, {x[2]}. Finally, {x[3]}."
    # n in 5..8: First, Then×(n-2), Finally
    mid = " ".join(f"Then, {t}." for t in x[1:-1])
    return f"First, {x[0]}. {mid} Finally, {x[-1]}."


def _temporal_index(x: list[str]) -> str:
    """'[1] … [2] …' (reference prompts.py:19-28)."""
    return " ".join(f"[{i + 1}] {t}." for i, t in enumerate(x))


def _static(x: list[str]) -> str:
    """'a. b. c.' (reference prompts.py:29-38)."""
    return " ".join(f"{t}." for t in x)


TEMPLATE_FUNCS = {
    "temporal_natural": _temporal_natural,
    "temporal_index": _temporal_index,
    "static": _static,
}


class Prompt:
    """reference prompts.py:41-311."""

    def __init__(self, template_txt: str, seed: int = 42):
        random.seed(seed)
        if os.path.exists(template_txt):
            with open(template_txt) as f:
                template = f.read()
        elif isinstance(template_txt, str):
            template = template_txt
        self.template = template

    # -- visual-token aggregation --------------------------------------------

    def _get_top_visual_tokens_v2(self, video_name, visual_tokens_object, topk):
        """Count-over-first-2-per-frame, top-k, temporal re-sort by mean frame
        index (reference prompts.py:52-73)."""
        frame_tokens = visual_tokens_object["frame_tokens"]
        count_dict = defaultdict(lambda: defaultdict(int))
        index_sum_dict = defaultdict(lambda: defaultdict(int))
        frm_candidate_k = 2
        for i in range(len(frame_tokens)):
            frame_token = frame_tokens[i]
            for key in ["objects", "attributes", "scenes", "verbs"]:
                if key in frame_token:
                    for s in frame_token[key][:frm_candidate_k]:
                        count_dict[key][s] += 1
                        index_sum_dict[key][s] += i
        topk_tokens = {}
        for key in ["objects", "attributes", "scenes", "verbs"]:
            candidate_list = sorted(
                [(text, count, index_sum_dict[key][text] / count)
                 for text, count in count_dict[key].items()],
                key=lambda x: x[1], reverse=True,
            )
            candidate_list = candidate_list[:topk]
            candidate_list = sorted(candidate_list, key=lambda x: x[2])
            topk_tokens[key] = [item[0].rstrip(".") for item in candidate_list]
        return topk_tokens

    def _get_top_visual_tokens_v3(self, video_name, visual_tokens_object, topk):
        """Blockwise selection + dedup of neighboring blocks
        (reference prompts.py:75-118)."""
        frame_tokens = visual_tokens_object["frame_tokens"]
        indices = np.linspace(0, len(frame_tokens), num=topk, dtype=int, endpoint=False)
        blocks = []
        for i in range(len(indices)):
            if i == len(indices) - 1:
                blocks.append((indices[i], len(frame_tokens)))
            else:
                blocks.append((indices[i], indices[i + 1]))
        candidate_tokens = defaultdict(list)
        for key in frame_tokens[0].keys():
            for start_i, end_i in blocks:
                frm_candidate_k = 2
                count_dict = defaultdict(int)
                rank_dict = defaultdict(int)
                for i in range(start_i, end_i):
                    for r in range(frm_candidate_k):
                        text = frame_tokens[i][key][r]
                        count_dict[text] += 1
                        rank_dict[text] += r
                cand_list = sorted(
                    [(k, -count_dict[k], rank_dict[k]) for k in count_dict.keys()],
                    key=lambda x: (x[1], x[2]),
                )
                chosen_text = ", ".join(
                    item[0].rstrip(".").strip() for item in cand_list[:frm_candidate_k]
                )
                candidate_tokens[key].append(chosen_text)
        topk_tokens = {}
        for key in ["objects", "attributes", "scenes", "verbs"]:
            cand_tokens = candidate_tokens[key]
            select_ids: list[int] = []
            for i in range(len(cand_tokens) - 1):
                if i == 0:
                    select_ids.append(i)
                elif cand_tokens[i] != cand_tokens[select_ids[-1]]:
                    select_ids.append(i)
            topk_tokens[key] = [cand_tokens[ii] for ii in select_ids]
        return topk_tokens

    # -- prompt construction --------------------------------------------------

    def construct_prompt(self, video_name, visual_tokens_object, frame_captions,
                         config, question=None, answer=None, asr=None,
                         vlep_example=None):
        """reference prompts.py:120-206."""
        topk = config["topk"]
        if config["visual_token_aggregation_version"] == "v2":
            topk_tokens = self._get_top_visual_tokens_v2(video_name, visual_tokens_object, topk)
        elif config["visual_token_aggregation_version"] == "v3":
            topk_tokens = self._get_top_visual_tokens_v3(video_name, visual_tokens_object, topk)
        else:
            raise NotImplementedError

        template_fn = TEMPLATE_FUNCS[config["prompt_temporal_template"]]

        # an EMPTY aggregated category degrades to its section being
        # skipped (same bytes as the flag being off). The reference
        # instead crashes outright on this degenerate input — its
        # fixed-arity TEMPLATE_FUNC[len(tokens)] table has no 0 entry
        # (prompts.py:147-157 KeyError) — so graceful skipping cannot
        # diverge from any reference output (tests/test_prompts.py fuzz).
        objects_str = (template_fn(topk_tokens["objects"])
                       if config["add_objects"] and topk_tokens["objects"] else None)
        events_str = (template_fn(topk_tokens["verbs"])
                      if config["add_events"] and topk_tokens["verbs"] else None)
        attributes_str = (template_fn(topk_tokens["attributes"])
                          if config["add_attributes"] and topk_tokens["attributes"] else None)
        scenes_str = (topk_tokens["scenes"][0]
                      if config["add_scenes"] and topk_tokens["scenes"] else None)
        ASR_str = asr if config["add_ASR"] else None

        original_caption = visual_tokens_object["caption"]

        caps = frame_captions[video_name]
        if len(caps) > topk:
            caption_list = [c.rstrip(".").strip() for c in caps[:topk]]
        else:
            caption_list = [c.rstrip(".").strip() for c in caps]
        frame_captions_str = template_fn(caption_list)

        if vlep_example is not None:
            return self._construct_prompt_base_vlep_multichoice(
                config, objects_str, events_str, attributes_str, scenes_str,
                frame_captions_str, ASR_str, original_caption, question, answer,
                vlep_example,
            )
        return self._construct_prompt_base(
            config, objects_str, events_str, attributes_str, scenes_str,
            frame_captions_str, ASR_str, original_caption, question, answer,
        )

    def _construct_prompt_base(self, config, objects_str, events_str,
                               attributes_str, scenes_str, frame_captions_str,
                               ASR_str, original_caption, question_str, answer_str):
        """reference prompts.py:209-271."""
        if not config["add_original_caption"]:
            original_caption = None
        if not config["add_frame_captions"]:
            frame_captions_str = None
        if not config["add_answer"]:
            answer_str = None

        p = self.template
        if scenes_str:
            p += "Scene: " + scenes_str + "\n"
        if objects_str:
            p += "Objects: " + objects_str + "\n"
        if events_str:
            p += "Events: " + events_str + "\n"
        if attributes_str:
            p += "Attributes: " + attributes_str + "\n"
        if frame_captions_str:
            p += "Frame Captions: " + frame_captions_str + "\n"
        if ASR_str:
            if config["prompt_task"] == "vlep":
                p += "Dialogue: " + ASR_str + "\n"
            else:
                p += "Subtitle: " + ASR_str + "\n"

        if config["prompt_task"] == "caption":
            p += "Video Caption:"
            if original_caption:
                if isinstance(original_caption, str):
                    p += " " + original_caption.strip()
                elif isinstance(original_caption, list):
                    random.shuffle(original_caption)
                    p += " " + original_caption[0].strip()
        elif config["prompt_task"] == "qa":
            assert question_str is not None
            p += "Question: " + question_str + "\n"
            p += "Answer:"
            if answer_str:
                p += " " + answer_str
        elif config["prompt_task"] == "vlep":
            p += "What is likely to happen next?"
            if original_caption:
                if isinstance(original_caption, str):
                    p += " " + original_caption.strip()
                elif isinstance(original_caption, list):
                    random.shuffle(original_caption)
                    p += " " + original_caption[0].strip()
        return p

    def _construct_prompt_base_vlep_multichoice(self, config, objects_str,
                                                events_str, attributes_str,
                                                scenes_str, frame_captions_str,
                                                ASR_str, original_caption,
                                                question_str, answer_str,
                                                vlep_example):
        """reference prompts.py:273-311."""
        if not config["add_frame_captions"]:
            frame_captions_str = None

        p = self.template
        if scenes_str:
            p += "Scene: " + scenes_str + "\n"
        if objects_str:
            p += "Objects: " + objects_str + "\n"
        if events_str:
            p += "Events: " + events_str + "\n"
        if attributes_str:
            p += "Attributes: " + attributes_str + "\n"
        if frame_captions_str:
            p += "Frame Captions: " + frame_captions_str + "\n"
        if ASR_str:
            p += "Dialogue: " + ASR_str + "\n"

        event_A, event_B = vlep_example["events"]
        p += f"Question: What is more likely to happen next? A:{event_A} B:{event_B}\nAnswer:"
        if config["add_original_caption"]:
            p += " " + vlep_example["answer"].strip()
        return p
