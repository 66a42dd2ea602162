"""Prompt generation for VLEP multichoice — the port's CLI.

    python -m vidil_tpu_torch.generate_prompts_random_prefix_vlep_multichoice ...

Drop-in equivalent of the reference
generate_prompts_random_prefix_vlep_multichoice.py (example-id-keyed
annotations, 'A:{event_A} B:{event_B}' multichoice suffix,
__idx_2_example_id.json side file). Host only.
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
    get_prompt_prefix_vlep,
    save_prompt_lines_vlep,
)
from vidil_tpu_torch.pipeline.prompts import Prompt

if __name__ == "__main__":
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--trainset_json_ann",
                        help="example_id-keyed train ann (video_id, events, answer)")
    parser.add_argument("--target_json_ann",
                        help="e.g. VLEP/ann/example_id_2_events_answer_dev.json")
    parser.add_argument("--train_dataset_visual_tokens_dir")
    parser.add_argument("--train_dataset_frame_captions_dir")
    parser.add_argument("--instruction_line")
    parser.add_argument("--shot", default=5)
    parser.add_argument("--seed", default=42)
    args = parser.parse_args()

    visual_tokens, filtered, unfiltered, _, video_2_asr = load_inputs(args)
    output_path = make_output_path(args)
    request_body = default_request_body(args, with_n=False)
    config = base_config_from_args(args, output_path, request_body)

    train_visual_tokens = json.load(
        open(os.path.join(args.train_dataset_visual_tokens_dir, "visual_tokens.json")))
    train_filtered = json.load(
        open(os.path.join(args.train_dataset_frame_captions_dir, "video_text_CapFilt.json")))
    train_unfiltered = json.load(
        open(os.path.join(args.train_dataset_frame_captions_dir, "video_text_Cap.json")))
    training_video_ann = json.load(open(args.trainset_json_ann))
    target_video_ann = json.load(open(args.target_json_ann))

    config["add_original_caption"] = True
    config["add_answer"] = True
    prefix = get_prompt_prefix_vlep(
        train_visual_tokens, train_filtered, train_unfiltered, training_video_ann,
        args.instruction_line, config, video_2_asr, int(args.shot), int(args.seed),
    )

    config["add_original_caption"] = args.add_original_caption
    config["add_answer"] = args.add_answer
    prompt = Prompt(prefix, seed=int(args.seed))
    save_prompt_lines_vlep(
        target_video_ann, visual_tokens, filtered, unfiltered, prompt, config,
        video_2_asr=video_2_asr,
    )
