"""Standalone retrieval evaluation on the GPU — the port's CLI.

    python -m vidil_tpu_torch.eval_retrieval_video --config CONFIG.yaml --output_dir OUT [--device cuda]

The root ``eval_retrieval_video.py``'s flags; the trainer's evaluation
(`train_retrieval_video.main` with ``evaluate``): val and test metrics
appended to ``evaluate.txt``.
"""

from vidil_tpu_torch.train_retrieval_video import parse_args, run_cli

if __name__ == "__main__":
    run_cli(parse_args(evaluate_flag=False, default_output="output/retrieval_eval"))
