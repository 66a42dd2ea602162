"""Readings that a cell's correctness limits are set from: for each seed,
one run of the cell with a short window, the numbers the program's timed
path reads against the plain reference, and the same numbers of the
control (the reference with float8 operands put in the program's place)
and of planted faults. The benchmark's own runs never do this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 4 \\
        [--control] [--faults half,exchange [--faults-only]] --out FILE.jsonl
    python3 portbench/calibrate.py --workload <training cell> --seeds 1,2,3 \\
        --control-only --out FILE.jsonl

Each run appends one JSON line to FILE: seed, fault, the program's
numbers with their diagnostics, the control's, the end-to-end metrics.
All runs of one call share the process (and its kernels); a cell on four
chips starts its other ranks per run, each through this script, so a
planted fault is planted in every rank. `--control-only` reads a
training cell's control without the program, on one card: the float8
reference's three steps on the cell's global batches against the float32
reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--faults-only", action="store_true")
    p.add_argument("--control-only", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--as-rank", default=None, help=argparse.SUPPRESS)
    args, rest = p.parse_known_args(argv)
    if args.as_rank is not None:  # another rank of a run: plant the same fault
        return run.main(rest + ["--workload", args.workload],
                        hooks={"fault": args.as_rank or None})
    faults = [None] * (not args.faults_only) + [f for f in args.faults.split(",") if f]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.control_only:
        return control_only(args.workload, seeds, args.out)
    for seed in seeds:
        for fault in faults:
            hooks = {"fault": fault, "control": args.control and fault is None,
                     "rank_command": [sys.executable, os.path.abspath(__file__),
                                      "--workload", args.workload, "--seeds", "0", "--out",
                                      args.out, "--as-rank", fault or ""]}
            argv_run = ["--workload", args.workload, "--seed", str(seed), "--seconds",
                        str(args.seconds), "--trace", "0"]
            rc = run.main(argv_run, hooks=hooks)
            out = hooks.get("result", {})
            line = {"seed": seed, "fault": fault, "rc": rc, "checks": out.get("checks"),
                    "detail": out.get("detail"), "control": out.get("control"),
                    "e2e": out.get("e2e"), "attempted": out.get("attempted")}
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
            print("calibration", json.dumps(line), file=sys.stderr, flush=True)
    return 0


def control_only(cell: str, seeds, out_path: str) -> int:
    import torch

    import generate
    import weights
    from reference import judge_train

    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, _, cfg, t = run.load_cell(bench, cell)
    dev = torch.device("cuda")
    for seed in seeds:
        batches = judge_train.global_batches(t, seed)
        steps = {}
        for prec in ("fp32", "fp8"):
            params = weights.draw(weights.captioner_spec(cfg), seed, dev, salt=1)
            steps[prec] = judge_train.reference_steps(cfg, params, batches,
                                                      generate.prompt_length(t), dev, prec,
                                                      rows_per_block=12)
        line = {"seed": seed, "fault": None, "control": judge_train.numbers(steps["fp8"],
                                                                            steps["fp32"])}
        with open(out_path, "a") as f:
            f.write(json.dumps(line) + "\n")
        print("calibration", json.dumps(line)[:600], file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
