"""CLI: processed GPT-3 response json -> pseudo-label training jsonl
(drop-in for the reference utils_gpt3/gpt3_response_to_jsonl.py). Host only.

    python -m vidil_tpu_torch.utils_gpt3.gpt3_response_to_jsonl \
        --gpt3_processed_dir D --output_dir O [--train_ann_json ANN]
"""

import argparse
import json
import os
from glob import glob

from vidil_tpu_torch.pipeline.gpt3 import video_level_only

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="msrvtt")
    parser.add_argument("--gpt3_processed_dir", default="")
    parser.add_argument("--output_dir", default="pseudo_label_ann_example")
    parser.add_argument("--train_ann_json", default="",
                        help="videoid-keyed train ann json restricting selected ids "
                             "(replaces the reference's hardcoded dataset paths)")
    args = parser.parse_args()

    for input_path in glob(os.path.join(args.gpt3_processed_dir, "*.json")):
        if args.train_ann_json:
            selected = json.load(open(args.train_ann_json)).keys()
        elif args.dataset == "msrvtt":
            selected = json.load(open("shared_datasets/MSRVTT_ret/ann/video_2_text_original_train.json")).keys()
        elif args.dataset == "vatex":
            selected = json.load(open("shared_datasets/Vatex/value_ann/vatex_en_c/videoid_2_text_vatex_en_c_train.json")).keys()
        else:
            selected = None
        video_level_only(input_path, args.output_dir, selected_ids=selected)
