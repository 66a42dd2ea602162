"""Whole tiny runs of the Kimi Linear cell on the CPU, each in a process of
its own, with tiny stand-ins for its configuration and traffic (four
layers: a dense one, then experts; KDA and MLA mixers; 4 of 8 experts
held, top-2 plus the shared one; a KDA chunk shorter than the prompts;
float32): the result line's shape, no JAX and no JAX package loaded,
every planted fault reads not correct, the float8 control reads apart from
the program; and `flops_kimi` by hand. Nothing here is a measurement."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
SEED = "3000000019"  # past 2**31
CELL = "lm_kimi_linear_vidil_prompts"
FAULTS = ["decay_per_head", "no_delta", "no_kv_norm", "all_experts_held",
          "gate_by_biased_scores", "state_reset", "graphed_decode_drift"]

# hidden 1024 and the published expert width 1024 keep the init's scale
# (std 0.02 over ~1-2k inputs gives pre-activations near one; at tiny
# widths the experts would add almost nothing, and no fault of their
# routing could show)
TINY_MODEL = {"vocab_size": 2048, "hidden_size": 512, "num_hidden_layers": 4,
              "linear_attn_config": {"full_attn_layers": [2, 4], "kda_layers": [1, 3],
                                     "head_dim": 32, "num_heads": 4,
                                     "short_conv_kernel_size": 4},
              "num_attention_heads": 4, "kv_lora_rank": 64, "qk_nope_head_dim": 32,
              "qk_rope_head_dim": 16, "v_head_dim": 32, "intermediate_size": 256,
              "moe_intermediate_size": 1024, "num_experts": 4, "num_experts_published": 8,
              "num_experts_per_token": 2, "chunk_size": 16, "dtype": "float32"}
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
import run, test_portbench_kimi as T
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
    """`weights_kimi.draw`: the layout the reference documents, the held
    experts only, the same for the same seed, drawn without the program."""
    import torch

    sys.path.insert(0, PB)
    import weights_kimi

    cfg = run_kwargs()["config"]
    w = weights_kimi.draw(cfg, int(SEED), "cpu", torch.bfloat16)
    d = cfg["hidden_size"]
    assert [(p["kind"], p["mlp"]) for p in w["layers"]] == [
        ("kda", "dense"), ("mla", "moe"), ("kda", "moe"), ("mla", "moe")]
    k = w["layers"][0]
    assert k["qkv"].shape == (3 * 4 * 32, d) and k["conv_w"].dtype == torch.float32
    assert k["A_log"].shape == (4,) and k["dt_bias"].shape == (4 * 32,)
    m = w["layers"][1]
    assert m["router"].shape == (8, d) and m["gate_up"].shape == (4, 2 * 1024, d)
    assert m["down"].shape == (4, d, 1024) and m["router_bias"].abs().min() > 0
    assert m["kv_b"].shape == (4 * (32 + 32), 64) and m["kv_a"].shape == (64 + 16, d)
    again = weights_kimi.draw(cfg, int(SEED), "cpu", torch.bfloat16)
    assert torch.equal(again["layers"][2]["gate_up"], w["layers"][2]["gate_up"])
    src = open(os.path.join(PB, "weights_kimi.py")).read()
    assert "vidil_tpu" not in src and "jax" not in src


def test_flops_by_hand():
    """`flops_kimi` at the cell's configuration against sums written out."""
    sys.path.insert(0, PB)
    import flops
    import flops_kimi

    c = _load(PB, "configs", "kimi_linear_48b_a3b_ep2.json")
    D, Ie = 2304, 1024
    kda = D * 12288 + 2 * (D * 128 + 128 * 4096) + D * 32 + 4096 * D + 12288 * 4
    mla = D * 32 * 192 + D * 576 + 512 * 32 * 256 + 32 * 128 * D
    moe = 256 * D + 3 * D * Ie * (8 * 0.5 + 1)
    assert flops_kimi.token_params(c) == 20 * kda + 7 * mla + 3 * D * 9216 + 26 * moe
    per_token = flops_kimi.token_flops(c, 10) - flops_kimi.token_flops(c, 9)
    assert per_token == 7 * 2.0 * 32 * (192 + 128)
    assert flops_kimi.k7_bound_s(c, 1000, 0, 0, 0) == 2.0 * 1000 * 3 * Ie * D / flops.PEAK_BF16
    assert flops_kimi.k7_bound_s(c, 0, 2, 64, 10) == (
        2 * 2.0 * 64 * (D + Ie) + 10 * 3 * Ie * D) / flops.PEAK_BYTES


def test_config_states_its_one_cut():
    """The configuration cuts one key, `num_experts`, to the card's share of
    the two-card deployment it states: the reduced key beside its
    `<key>_published` value, and every other number the model reads the
    published one (`KimiLinearConfig`'s defaults are the published
    config.json's)."""
    sys.path.insert(0, ROOT)
    from vidil_tpu_torch.config import KimiLinearConfig

    bench = _load(ROOT, "BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == "kimi_linear_48b_a3b_ep2")
    cfg = _load(ROOT, entry["file"])
    assert cfg["reduced"] == entry["reduced"] == ["num_experts"]
    for key in cfg["reduced"]:
        assert cfg[f"{key}_published"] not in (None, cfg[key])
    assert (cfg["num_experts"], cfg["num_experts_published"], cfg["expert_offset"]) == (
        128, 256, 0)
    assert "expert parallelism" in cfg["deployment"] and "experts 0-127" in cfg["deployment"]
    published = KimiLinearConfig()
    program = KimiLinearConfig.from_dict(cfg)
    for f in dataclasses.fields(KimiLinearConfig):
        if f.name not in cfg["reduced"] + ["num_experts_published"]:
            assert getattr(program, f.name) == getattr(published, f.name), f.name
