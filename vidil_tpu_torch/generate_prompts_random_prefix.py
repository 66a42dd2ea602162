"""Prompt generation with a randomly-sampled few-shot prefix — the port's CLI.

    python -m vidil_tpu_torch.generate_prompts_random_prefix ...

Drop-in equivalent of the reference generate_prompts_random_prefix.py
(seeded few-shot sampling, optional permutations, gt-filled examples).
Host only.
"""

import argparse
import json
import os

from vidil_tpu_torch.generate_prompts_fixed_prefix import (
    add_common_args,
    load_inputs,
    make_output_path,
)
from vidil_tpu_torch.pipeline.generate_prompts import (
    base_config_from_args,
    default_request_body,
    get_prompt_prefix,
    save_prompt_lines,
)
from vidil_tpu_torch.pipeline.prompts import Prompt

if __name__ == "__main__":
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--gpt3_num_generation", default=1, type=int)
    parser.add_argument("--trainset_json_ann")
    parser.add_argument("--train_dataset_visual_tokens_dir")
    parser.add_argument("--train_dataset_frame_captions_dir")
    parser.add_argument("--instruction_line")
    parser.add_argument("--shot", default=5)
    parser.add_argument("--seed", default=42)
    parser.add_argument("--permutate", default=-1, type=int)
    args = parser.parse_args()

    visual_tokens, filtered, unfiltered, qa_pairs, video_2_asr = load_inputs(args)
    output_path = make_output_path(args)
    request_body = default_request_body(args, with_n=True)
    config = base_config_from_args(args, output_path, request_body)
    config["permutate"] = args.permutate

    train_visual_tokens = json.load(
        open(os.path.join(args.train_dataset_visual_tokens_dir, "visual_tokens.json")))
    train_filtered = json.load(
        open(os.path.join(args.train_dataset_frame_captions_dir, "video_text_CapFilt.json")))
    train_unfiltered = json.load(
        open(os.path.join(args.train_dataset_frame_captions_dir, "video_text_Cap.json")))
    training_video_ids = sorted(json.load(open(args.trainset_json_ann)).keys())

    # few-shot examples carry gt captions/answers (reference :141-143)
    config["add_original_caption"] = True
    config["add_answer"] = True
    prompt_prefix_strs, _, _ = get_prompt_prefix(
        train_visual_tokens, train_filtered, train_unfiltered, training_video_ids,
        args.instruction_line, config, qa_pairs, video_2_asr,
        int(args.shot), int(args.seed),
    )

    print(len(prompt_prefix_strs))
    original_output_path = config["output_path"]
    for i, prefix in enumerate(prompt_prefix_strs):
        prompt = Prompt(prefix, seed=int(args.seed))
        config["add_original_caption"] = args.add_original_caption
        config["add_answer"] = args.add_answer
        if config["permutate"] != -1:
            config["output_path"] = original_output_path[:-6] + f"_permutate_{i}.jsonl"
        save_prompt_lines(
            visual_tokens, filtered, unfiltered, prompt, config,
            video_2_question_answer_pairs=qa_pairs, video_2_asr=video_2_asr,
            asr_empty_values=(), vlep_truncate=True,
        )
