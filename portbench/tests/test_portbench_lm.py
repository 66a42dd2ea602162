"""Whole tiny runs of the language-model cell on the CPU, each in a process
of its own, with tiny stand-ins for its configuration and traffic (one
layer of each kind, 8 experts top-2 plus the shared one, a scan chunk
shorter than the prompts, float32): the result line's shape, no JAX and no JAX
package loaded, every planted fault reads not correct, and the float8
control reads apart from the program. Nothing here is a measurement."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
SEED = "3000000019"  # past 2**31
CELL = "lm_nemotron3_nano_vidil_prompts"
FAULTS = ["no_shared_expert", "top5", "state_reset", "no_d_skip", "gate_by_biased_scores",
          "graphed_decode_drift"]

# hidden 1024 keeps the published init's scale (std 0.02 over ~2.7k inputs
# gives unit pre-activations; over 64 the relu^2 experts would add almost
# nothing, and no fault of theirs could show)
TINY_MODEL = {"vocab_size": 2048, "hidden_size": 1024, "hybrid_override_pattern": "ME*EM",
              "mamba_num_heads": 8, "mamba_head_dim": 32, "ssm_state_size": 16, "n_groups": 2,
              "chunk_size": 16, "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 32, "n_routed_experts": 8, "num_experts_per_tok": 2,
              "moe_intermediate_size": 128, "moe_shared_expert_intermediate_size": 192,
              "dtype": "float32"}
TINY_TRAFFIC = {"prompts": 3, "pool_chunks": 3, "shots": 2, "prompt_tokens": [220, 300],
                "caption_words": [1, 6], "support_set": 24, "max_prompt_tokens": 400,
                "max_new_tokens": 6, "warmup_chunks": 3, "profile_from": 1,
                "profile_chunks": 1, "check_prompts": 2}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def run_kwargs() -> dict:
    """run.main's keywords for a tiny run of the cell on the CPU."""
    bench = _load(ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = dict(copy.deepcopy(_load(PB, "configs", f"{entry['config']}.json")), **TINY_MODEL)
    traffic = dict(_load(PB, "traffic", f"{entry['traffic']}.json"), **TINY_TRAFFIC)
    return dict(device="cpu", bench=bench, workload=_load(PB, "workloads", f"{CELL}.json"),
                config=config, traffic=traffic)


CODE = """
import json, sys
sys.path[:0] = [{here!r}, {pb!r}]
import run, test_portbench_lm as T
argv = sys.argv[2:]
hooks = {{"fault": sys.argv[1] or None, "control": sys.argv[1] == "control"}}
if hooks["control"]:
    hooks["fault"] = None
rc = run.main(argv, **T.run_kwargs(), hooks=hooks)
r = hooks["result"]
bad = sorted({{m.split('.')[0] for m in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'vidil_tpu'}})
print("READ", json.dumps([r["checks"], r.get("control"), r["detail"], bad]), file=sys.stderr)
sys.exit(rc)
"""


def tiny_run(tmp_path, fault="", trace="0"):
    cmd = [sys.executable, "-c", CODE.format(here=HERE, pb=PB), fault, "--workload", CELL,
           "--seed", SEED, "--seconds", "1", "--trace", trace]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    checks, control, detail, bad = json.loads(p.stderr.split("READ ", 1)[1].splitlines()[0])
    return line, checks, control, detail, bad


def test_line_and_no_jax(tmp_path):
    line, checks, _, detail, bad = tiny_run(tmp_path, trace="1")
    assert bad == []
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == {
        "logit_gap", "answer_gap", "route_flip_share", "rerun_mismatched_tokens"}
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["metrics"] == {}  # a run off the card reports no timing
    assert line["checks"]["rerun_mismatched_tokens"]["value"] == 0 and detail["_positions"] > 0
    assert detail["_reference_s"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_path_is_not_correct(fault, tmp_path):
    line, checks, _, _, _ = tiny_run(tmp_path, fault)
    assert line["correct"] is False, checks


def test_control_reads_apart(tmp_path):
    """The float8 control, put in the program's place, reads at least three
    times the program's reading on one of the cell's numbers."""
    _, prog, ctl, _, _ = tiny_run(tmp_path, "control")
    assert any(ctl[k] >= 3 * prog[k] and ctl[k] > 0 for k in prog), (prog, ctl)


def test_weights_are_the_benchmarks_own_at_the_assumed_rules():
    """`weights_lm.draw`: the layout the reference documents, at the
    configuration's assumed distributions, the same for the same seed and
    drawn without the program."""
    import math

    import torch

    sys.path.insert(0, PB)
    import weights_lm

    cfg = run_kwargs()["config"]
    w = weights_lm.draw(cfg, int(SEED), "cpu", torch.bfloat16)
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    inner = cfg["mamba_num_heads"] * cfg["mamba_head_dim"]
    conv = inner + 2 * cfg["n_groups"] * cfg["ssm_state_size"]
    assert [p["kind"] for p in w["layers"]] == list(cfg["hybrid_override_pattern"])
    assert w["embed"].shape == w["lm_head"].shape == (v, d) and w["embed"].dtype == torch.bfloat16
    assert abs(w["embed"].float().std().item() - 0.02) < 1e-3
    m = w["layers"][0]
    assert m["in_proj"].shape == (2 * inner + conv - inner + cfg["mamba_num_heads"], d)
    assert m["conv_w"].shape == (conv, cfg["conv_kernel"]) and m["conv_w"].abs().max() <= 0.5
    assert m["A_log"].dtype == torch.float32
    assert bool(((m["A_log"] >= 0) & (m["A_log"] <= math.log(16))).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((dt >= cfg["time_step_min"] * 0.999) & (dt <= cfg["time_step_max"] * 1.001)).all())
    assert torch.equal(m["D"], torch.ones(cfg["mamba_num_heads"]))
    e = w["layers"][1]
    E, I = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    assert e["up"].shape == (E, I, d) and e["down"].shape == (E, d, I)
    assert e["router"].dtype == e["router_bias"].dtype == torch.float32
    assert e["router_bias"].abs().min() > 0
    a = w["layers"][2]
    hd = cfg["head_dim"]
    assert a["q"].shape == (cfg["num_attention_heads"] * hd, d)
    assert a["k"].shape == a["v"].shape == (cfg["num_key_value_heads"] * hd, d)
    again = weights_lm.draw(cfg, int(SEED), "cpu", torch.bfloat16)
    assert torch.equal(again["layers"][1]["up"], e["up"])
    assert not torch.equal(weights_lm.draw(cfg, int(SEED) + 1, "cpu")["embed"], w["embed"])
    src = open(os.path.join(PB, "weights_lm.py")).read()
    assert "vidil_tpu" not in src and "jax" not in src
