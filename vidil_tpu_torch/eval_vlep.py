"""VLEP eval CLI (drop-in for the reference eval_vlep.py).

    python -m vidil_tpu_torch.eval_vlep --gpt3_processed_response R.json \
        --output_path OUT.jsonl --example_id_2_data ANN.json [--device cpu]

The SBERT encoder is the local MPNet snapshot that ``VIDIL_SBERT_MODEL``
names, on ``--device`` (CUDA by default; a model name or a missing card
raises).
"""

import argparse
import json
import os

from vidil_tpu_torch.evals.qa import _default_encoder
from vidil_tpu_torch.evals.vlep import eval_multichoice, eval_openended, vlep_accuracy

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpt3_processed_response", default="")
    parser.add_argument("--output_path", default="")
    parser.add_argument("--example_id_2_data",
                        default="shared_datasets/VLEP/ann/example_id_2_events_answer_test.json")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    encoder = _default_encoder(args.device)

    example_id_2_data = json.load(open(args.example_id_2_data))
    results = json.load(open(args.gpt3_processed_response))
    result_file_name = os.path.basename(args.gpt3_processed_response)
    if "multichoice" in result_file_name:
        lines = eval_multichoice(results, example_id_2_data, args.output_path, encoder=encoder)
    else:
        lines = eval_openended(results, example_id_2_data, args.output_path, encoder=encoder)
    acc = vlep_accuracy(lines, example_id_2_data)
    if acc:
        print("accuracy (where gt available):", acc)
