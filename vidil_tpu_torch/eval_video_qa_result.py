"""Video QA eval CLI (drop-in for the reference eval_video_qa_result.py).

    python -m vidil_tpu_torch.eval_video_qa_result --setting generation_gpt3_raw \
        --pred_jsonl R.jsonl --idx_2_video_id MAP.json --gt GT.jsonl \
        --answer_list_json A.json [--device cpu]

The generation settings map answers with the SBERT encoder of the local
MPNet snapshot that ``VIDIL_SBERT_MODEL`` names, on ``--device`` (CUDA by
default; a model name or a missing card raises); 'ranking' needs none.
"""

import argparse
import json
import os

from vidil_tpu_torch.evals.qa import (
    _default_encoder,
    evaluate_generation_result,
    evaluate_generation_result_jsonl,
    evaluate_generation_result_jsonl_majority_vote,
    evaluate_ranking_result,
    process_gpt3_response_jsonl,
)

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred", default="", help="prediction json")
    parser.add_argument("--pred_jsonl", default="", help="prediction jsonl")
    parser.add_argument("--idx_2_video_id", default="")
    parser.add_argument("--ans2label", default="")
    parser.add_argument("--gt", help="ground truth jsonl")
    parser.add_argument("--answer_list_json", help="closed answer list json")
    parser.add_argument("--setting", help="'ranking' | 'generation' | 'generation_gpt3_raw' | "
                                          "'generation_gpt3_raw_majority_vote'")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    assert args.pred != "" or args.pred_jsonl != ""

    if args.setting == "generation":
        encoder = _default_encoder(args.device)
        if args.pred_jsonl != "":
            idx_2_video_id = json.load(open(args.idx_2_video_id))
            evaluate_generation_result_jsonl(args.pred_jsonl, args.gt, args.answer_list_json,
                                             idx_2_video_id, encoder=encoder)
        else:
            evaluate_generation_result(args.pred, args.gt, args.answer_list_json, encoder=encoder)
    elif args.setting == "ranking":
        evaluate_ranking_result(args.pred, args.gt)
    elif args.setting == "generation_gpt3_raw":
        encoder = _default_encoder(args.device)
        tmp = process_gpt3_response_jsonl(args.pred_jsonl, os.path.dirname(args.pred_jsonl))
        idx_2_video_id = json.load(open(args.idx_2_video_id))
        evaluate_generation_result_jsonl(tmp, args.gt, args.answer_list_json, idx_2_video_id,
                                         encoder=encoder)
    elif args.setting == "generation_gpt3_raw_majority_vote":
        encoder = _default_encoder(args.device)
        tmp = process_gpt3_response_jsonl(args.pred_jsonl, os.path.dirname(args.pred_jsonl))
        idx_2_video_id = json.load(open(args.idx_2_video_id))
        evaluate_generation_result_jsonl_majority_vote(tmp, args.gt, args.answer_list_json,
                                                       idx_2_video_id, encoder=encoder)
