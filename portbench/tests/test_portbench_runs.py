"""Whole runs of each cell at tiny widths on the CPU (`rank_cpu.py`, each
in a process of its own): the result line's shape, no JAX and no JAX
package loaded, the timed path broken underneath each way the cell can
break (the check must read `correct` false), and the float8 control read
apart from the program. The run's look for cards is skipped; nothing
here is a measurement."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
SEED = "3000000019"  # past 2**31: a seed may need more than 32 signed bits


def tiny_run(cell, fault="", seconds="1", trace="0", tmp_path=None, code=None):
    cmd = [sys.executable, os.path.join(HERE, "rank_cpu.py"), fault, "--workload", cell,
           "--seed", SEED, "--seconds", seconds, "--trace", trace]
    if code is not None:
        cmd = [sys.executable, "-c", code, *cmd[2:]]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


CELLS = ["capfilt_msrvtt_beam", "capfilt_msrvtt_filter_only", "caption_ft_msrvtt_b12"]


@pytest.mark.parametrize("cell", CELLS)
def test_line_and_no_jax(cell, tmp_path):
    code = ("import sys; sys.argv = ['rank_cpu.py'] + sys.argv[1:]; "
            f"sys.path.insert(0, {HERE!r}); "
            "import rank_cpu; rc = rank_cpu.main(sys.argv[1:]); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vidil_tpu'}); "
            "print('loaded', bad, file=sys.stderr); sys.exit(rc or (5 if bad else 0))")
    line, err = tiny_run(cell, trace="1", tmp_path=tmp_path, code=code)
    assert "loaded []" in err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["metrics"] == {}  # a run off the card reports no timing
    for name, c in line["checks"].items():
        assert f"check {name}:" in err and c["value"] >= 0


FAULTS = [("capfilt_msrvtt_beam", "token"), ("capfilt_msrvtt_filter_only", "answer"),
          ("caption_ft_msrvtt_b12", "half"), ("caption_ft_msrvtt_b12", "unchanged")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(cell, fault, tmp_path):
    line, _ = tiny_run(cell, fault, tmp_path=tmp_path)
    assert line["correct"] is False, line["checks"]


def test_four_ranks_without_the_exchange_are_not_correct(tmp_path):
    """A cell on four chips runs as four processes: the b12 step over four
    gloo ranks reads as one process on the global batch; with the gradient
    all-reduce left out, not correct."""
    cell = tiny.FOUR_RANKS["name"]
    sound, _ = tiny_run(cell, tmp_path=tmp_path)
    assert sound["correct"] is True and sound["device"]["count"] == 4
    broken, _ = tiny_run(cell, "exchange", tmp_path=tmp_path)
    assert broken["correct"] is False
    assert broken["checks"]["grad_gap"]["value"] > 10 * sound["checks"]["grad_gap"]["value"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_apart(cell, tmp_path):
    """The float8 control, put in the program's place, reads at least three
    times the program's reading on one of the cell's numbers."""
    code = ("import sys, json; sys.path.insert(0, %r); import rank_cpu, run, tiny; "
            "argv = sys.argv[2:]; cell = argv[argv.index('--workload') + 1]; "
            "hooks = {'control': True}; rc = run.main(argv, **tiny.run_kwargs(cell), hooks=hooks); "
            "r = hooks['result']; print('READ', json.dumps([r['checks'], r['control']]), "
            "file=sys.stderr); sys.exit(rc)") % HERE
    _, err = tiny_run(cell, tmp_path=tmp_path, code=code)
    prog, ctl = json.loads(err.split("READ ", 1)[1].splitlines()[0])
    assert any(ctl[k] >= 3 * prog[k] and ctl[k] > 0 for k in prog), (prog, ctl)


@pytest.mark.cuda
def test_one_short_run_on_the_card(tmp_path):
    """On a card: one short run of the beam cell prints the contract's line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload",
                        "capfilt_msrvtt_beam", "--seed", SEED, "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200,
                       env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and "frames_per_s" in line["metrics"]
