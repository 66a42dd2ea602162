"""Prompt generation with a fixed prefix txt file — the port's CLI.

    python -m vidil_tpu_torch.generate_prompts_fixed_prefix --prompt_prefix P.txt ...

Drop-in equivalent of the reference generate_prompts_fixed_prefix.py
(and of the JAX package's root CLI): same argparse surface, jsonl
request-body format and ``__idx_2_videoid.json`` side file. Host only.
"""

import argparse
import json
import os

from vidil_tpu_torch.pipeline.generate_prompts import (
    base_config_from_args,
    default_request_body,
    save_prompt_lines,
)
from vidil_tpu_torch.pipeline.prompts import Prompt


def add_common_args(parser):
    parser.add_argument("--prompt_task", default="caption")
    parser.add_argument("--visual_tokens_dir")
    parser.add_argument("--frame_captions_dir")
    parser.add_argument("--question_answer_path", default="")
    parser.add_argument("--asr_path", default="")
    parser.add_argument("--prompt_temporal_template", default="temporal_natural")
    parser.add_argument("--output_dir")
    parser.add_argument("--output_name", default="gpt3_queries.jsonl")
    parser.add_argument("--caption_all_video", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_objects", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_events", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_attributes", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_scenes", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_original_caption", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_frame_captions", default=True, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_ASR", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--add_answer", default=False, action=argparse.BooleanOptionalAction)
    parser.add_argument("--gpt3_temperature", default=0.0, type=float)
    parser.add_argument("--gpt3_max_tokens", default=64, type=int)
    parser.add_argument("--gpt3_top_p", default=1, type=int)
    return parser


def load_inputs(args):
    visual_tokens = json.load(open(os.path.join(args.visual_tokens_dir, "visual_tokens.json")))
    filtered = json.load(open(os.path.join(args.frame_captions_dir, "video_text_CapFilt.json")))
    unfiltered = json.load(open(os.path.join(args.frame_captions_dir, "video_text_Cap.json")))
    if args.prompt_task == "qa":
        assert args.question_answer_path != ""
        qa_pairs = json.load(open(args.question_answer_path))
    else:
        qa_pairs = None
    if args.asr_path != "" and args.add_ASR:
        video_2_asr = json.load(open(args.asr_path))
    else:
        video_2_asr = None
    return visual_tokens, filtered, unfiltered, qa_pairs, video_2_asr


def make_output_path(args):
    os.makedirs(args.output_dir, exist_ok=True)
    return os.path.join(args.output_dir, f"temp_{args.gpt3_temperature}_" + args.output_name)


if __name__ == "__main__":
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--prompt_prefix", help="path to a txt file")
    args = parser.parse_args()

    visual_tokens, filtered, unfiltered, qa_pairs, video_2_asr = load_inputs(args)
    prompt = Prompt(args.prompt_prefix)
    output_path = make_output_path(args)
    request_body = default_request_body(args, with_n=False)
    config = base_config_from_args(args, output_path, request_body)

    save_prompt_lines(
        visual_tokens, filtered, unfiltered, prompt, config,
        video_2_question_answer_pairs=qa_pairs, video_2_asr=video_2_asr,
        asr_empty_values=("",), vlep_truncate=False,
    )
