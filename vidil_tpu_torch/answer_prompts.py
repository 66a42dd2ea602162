"""Answer VidIL's few-shot prompts with a Nemotron-H model on the card.

    python -m vidil_tpu_torch.answer_prompts --prompts PROMPTS.jsonl --out RESPONSES.jsonl \\
        --vocab VOCAB.txt [--config CONFIG.json] [--checkpoint PARAMS.pt | --seed N]

Reads the prompt jsonl that the prompt generators write (one GPT-3 request
body a line), answers every prompt greedily (`pipeline/lm_answer.py`) and
writes one ``{"choices": [{"text": ...}]}`` line a prompt, in prompt
order: the response file `utils_gpt3.process_gpt3_response` reads.

The model is `config.NemotronHConfig` (NVIDIA-Nemotron-3-Nano-30B-A3B by
default; ``--config`` a config.json-shaped file of its keys). Its weights
are a `torch.save` of the port's parameter dict (``--checkpoint``, the
layout of `models/nemotron_h.py:init_nemotron_h`) or drawn from ``--seed``;
the vocabulary is a whole-word list, one entry a line (`WordTokenizer`).
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prompts", required=True, help="prompt jsonl (GPT-3 request bodies)")
    p.add_argument("--out", required=True, help="response jsonl to write")
    p.add_argument("--vocab", required=True, help="whole-word vocabulary, one entry a line")
    p.add_argument("--config", default=None, help="config.json of the model (default: "
                   "NVIDIA-Nemotron-3-Nano-30B-A3B)")
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("--checkpoint", default=None, help="torch.save'd parameter dict")
    weights.add_argument("--seed", type=int, default=None, help="draw the weights from a seed")
    p.add_argument("--batch", type=int, default=16, help="prompts a chunk")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--max_prompt_tokens", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from vidil_tpu_torch.config import NemotronHConfig
    from vidil_tpu_torch.models.nemotron_h import init_nemotron_h
    from vidil_tpu_torch.pipeline import lm_answer

    device = torch.device(args.device)
    if args.config:
        with open(args.config) as f:
            cfg = NemotronHConfig.from_dict(json.load(f))
    else:
        cfg = NemotronHConfig()
    if args.checkpoint:
        params = torch.load(args.checkpoint, map_location=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_nemotron_h(cfg, gen, device)
    tok = lm_answer.WordTokenizer.from_file(args.vocab)
    engine = lm_answer.LMAnswerEngine(params, cfg, tok, max_prompt_tokens=args.max_prompt_tokens,
                                      max_new_tokens=args.max_new_tokens, device=device)
    prompts = lm_answer.read_prompts(args.prompts)
    with torch.no_grad():
        answers = lm_answer.answer_all(engine, prompts, args.batch)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lm_answer.write_responses(args.out, answers)
    print(f"answered {len(answers)} prompts: {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
