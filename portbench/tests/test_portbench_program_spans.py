"""The per-layer metrics that read the program's own spans
(`vidil_tpu_torch/utils/profiling.py:span_totals`): a tiny traced run of
each cell on the CPU, in a process of its own, after which each reader
returns a number, and each names spans the program recorded in the
profiled sub-window. `result_line` reads no metric off the card, so this
is their only check off it. Nothing here is a measurement."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SEED = "3000000023"

# a traced run, then every span reader of the cell on its trace
CODE = """
import importlib.util, json, os, sys
sys.path[:0] = [{here!r}, {pb!r}]
import run, tiny
from vidil_tpu_torch.utils import profiling
argv = sys.argv[1:]
cell = argv[argv.index('--workload') + 1]
hooks = {{}}
rc = run.main(argv, **tiny.run_kwargs(cell), hooks=hooks)
out = {{'rc': rc, 'totals': profiling.span_totals(), 'readers': {{}}}}
for name in json.loads(os.environ['SPAN_METRICS']):
    path = os.path.join({pb!r}, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location('m_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out['readers'][name] = [mod.SPAN, mod.PER, mod.read(hooks['result']['trace'])]
print('SPANS', json.dumps(out), file=sys.stderr)
sys.exit(rc)
"""


def _span_metrics(cell: str) -> list[str]:
    """The cell's per-layer metrics whose reader reads the program's spans."""
    names = []
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]) and m["source"] == "program_span":
            with open(os.path.join(PB, "metrics", f"{m['name']}.py")) as f:
                if "span_totals" in f.read():
                    names.append(m["name"])
    return names


@pytest.mark.parametrize("cell,root,count", [("capfilt_msrvtt_beam", "capfilt.dispatch", 6),
                                             ("caption_ft_msrvtt_b12", "train.step", 4)])
def test_span_readers_read_the_traced_window(cell, root, count, tmp_path):
    """A window long enough for the profiled chunks or steps (the tiny
    traffic's 2, from the second on) on a loaded host."""
    names = _span_metrics(cell)
    assert len(names) == count, names
    cmd = [sys.executable, "-c", CODE.format(here=HERE, pb=PB), "--workload", cell,
           "--seed", SEED, "--seconds", "8", "--trace", "1"]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2",
               SPAN_METRICS=json.dumps(names))
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stderr.split("SPANS ", 1)[1].splitlines()[0])
    totals = out["totals"]
    for name, (span, per, value) in out["readers"].items():
        assert span in totals and per in totals, (name, span, per, sorted(totals))
        assert isinstance(value, float) and value > 0, (name, value)
        assert value <= 1e3 * totals[root][1] / totals[root][0], name
    # the profiled sub-window alone: the traffic's profiled chunks or steps
    assert totals[root][0] == 2
    if root == "capfilt.dispatch":
        assert totals["capfilt.complete"][0] == 2
        # "a picture of " is 3 words after [DEC]; 20 tokens
        assert totals["decode.select"][0] == 2 * 16 and totals["decode.step"][0] == 2 * 15


@pytest.mark.parametrize("name", _span_metrics("capfilt_msrvtt_beam")
                         + _span_metrics("caption_ft_msrvtt_b12"))
def test_span_reader_without_spans_reads_nothing(name, monkeypatch):
    """With no span recorded (tracing off, or a program without spans) a
    reader returns None and does not raise."""
    import importlib.util

    from vidil_tpu_torch.utils import profiling

    spec = importlib.util.spec_from_file_location("m", os.path.join(PB, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(profiling, "_totals", {})
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert mod.read({}) is None
