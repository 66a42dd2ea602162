"""CLI: raw GPT-3 response jsonl -> processed videoid-keyed caption json
(drop-in for the reference utils_gpt3/process_gpt3_response.py). Host only.

    python -m vidil_tpu_torch.utils_gpt3.process_gpt3_response \
        --gpt3_response_dir R --input_prompts_dir P --output_dir O
"""

import argparse
import os
from glob import glob

from vidil_tpu_torch.pipeline.gpt3 import process_gpt3_response

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpt3_response_dir", default="", help="dir containing raw gpt3 response jsonl")
    parser.add_argument("--input_prompts_dir", default="", help="input_prompts dir containing input jsonls and idx2id jsons")
    parser.add_argument("--output_dir", default="", help="output dir storing processed gpt3 response json")
    args = parser.parse_args()

    for response_file in glob(os.path.join(args.gpt3_response_dir, "*.jsonl")):
        input_name = os.path.basename(response_file)[:-6]
        idx_2_videoid_path = os.path.join(args.input_prompts_dir, f"{input_name}__idx_2_videoid.json")
        output_path = os.path.join(args.output_dir, f"processed_{input_name}.json")
        process_gpt3_response(idx_2_videoid_path, response_file, output_path)
