"""Caption metric CLI (drop-in for the reference
eval_video_captioning_results.py). Host only.

    python -m vidil_tpu_torch.eval_video_captioning_results \
        --gpt3_response_file R.jsonl --idx_2_videoid_json MAP.json --gt_jsonl GT.jsonl
"""

import argparse
import os

from vidil_tpu_torch.evals.caption import eval_captioning_from_gpt3_response, video_caption_eval

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpt3_response_file", default="", help="raw gpt3 response jsonl")
    parser.add_argument("--idx_2_videoid_json", default="", help="line idx -> videoid json")
    parser.add_argument("--gt_jsonl", help="gt caption jsonl (caption/clip_name lines)")
    parser.add_argument("--results_file", default="", help="direct results json (skip gpt3 processing)")
    parser.add_argument("--output_dir", default="output/caption_eval")
    args = parser.parse_args()

    os.makedirs(args.output_dir, exist_ok=True)
    if args.results_file:
        video_caption_eval(args.gt_jsonl, args.results_file,
                           output_path=os.path.join(args.output_dir, "metric.json"))
    else:
        eval_captioning_from_gpt3_response(args.gpt3_response_file, args.idx_2_videoid_json,
                                           args.gt_jsonl, args.output_dir)
