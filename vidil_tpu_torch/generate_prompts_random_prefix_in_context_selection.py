"""Prompt generation with SBERT in-context example selection — the port's CLI.

    python -m vidil_tpu_torch.generate_prompts_random_prefix_in_context_selection \
        --sbert_model DIR [--device cpu] ...

Drop-in equivalent of the reference
generate_prompts_random_prefix_in_context_selection.py: sample a support
set of `shot` training examples, then per query pick the N most similar
by SBERT cosine (highest at the bottom). The SBERT encoder is the port's
MPNet from the local snapshot ``--sbert_model`` (config.json, vocab.txt,
pytorch_model.bin or model.safetensors), in bf16 on ``--device`` (CUDA by
default; a model name or a missing card raises).
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
    make_sbert_encoder,
    save_prompt_lines_with_in_context_selection,
)


def parse_args(argv=None):
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--gpt3_num_generation", default=1, type=int)
    parser.add_argument("--trainset_json_ann")
    parser.add_argument("--train_dataset_visual_tokens_dir")
    parser.add_argument("--train_dataset_frame_captions_dir")
    parser.add_argument("--instruction_line")
    parser.add_argument("--shot", default=5)
    parser.add_argument("--seed", default=42)
    parser.add_argument("--N", default=5, type=int)
    parser.add_argument("--permutate", default=-1, type=int)
    parser.add_argument("--comparing_target", default="question", type=str)
    parser.add_argument("--sbert_model", default="all-mpnet-base-v2",
                        help="local MPNet snapshot directory (a name raises: no download)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(args):
    # first, so that a missing card or snapshot fails before any file is written
    encoder = make_sbert_encoder(args.sbert_model, device=args.device)

    print("using camparting target: ", args.comparing_target)
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

    config["add_original_caption"] = True
    config["add_answer"] = True
    _, in_context_examples, _ = get_prompt_prefix(
        train_visual_tokens, train_filtered, train_unfiltered, training_video_ids,
        args.instruction_line, config, qa_pairs, video_2_asr,
        int(args.shot), int(args.seed), asr_empty_values=("", " "),
    )

    config["add_original_caption"] = args.add_original_caption
    config["add_answer"] = args.add_answer

    save_prompt_lines_with_in_context_selection(
        visual_tokens, filtered, unfiltered, args.N, args.instruction_line,
        in_context_examples, config,
        video_2_question_answer_pairs=qa_pairs, video_2_asr=video_2_asr,
        comparing_target=args.comparing_target,
        encoder=encoder,
    )


if __name__ == "__main__":
    main(parse_args())
