"""`decode_graphed_share.capfilt` (`portbench/metrics/`): the share of the
profiled dispatches whose beam decode replayed CUDA graphs, from the
program's registry of span calls. On the CPU the decode never replays, so
a tiny traced run reads 0; with the counts given it reads their ratio;
without a registry, a dispatch or the decode graphs it reads None. Nothing
here is a measurement."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
NAME = "decode_graphed_share.capfilt"

CODE = """
import importlib.util, json, os, sys
sys.path[:0] = [{here!r}, {pb!r}]
import run, tiny
from vidil_tpu_torch.utils import profiling
argv = sys.argv[1:]
hooks = {{}}
rc = run.main(argv, **tiny.run_kwargs("capfilt_msrvtt_beam"), hooks=hooks)
spec = importlib.util.spec_from_file_location("m", os.path.join({pb!r}, "metrics", {name!r} + ".py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
calls = {{k: c for k, (c, _) in profiling.span_totals().items()}}
print("SHARE", json.dumps({{"rc": rc, "calls": calls, "value": mod.read(hooks["result"]["trace"])}}),
      file=sys.stderr)
sys.exit(rc)
"""


def _reader():
    spec = importlib.util.spec_from_file_location("m", os.path.join(PB, "metrics", f"{NAME}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_names_the_beam_cell_and_the_decode_layer():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["capfilt_msrvtt_beam"] and entry["moves"] == "frames_per_s"
    assert entry["layer"] == "beam decode (ops/generation.py, models/med.py decode)"
    assert (entry["unit"], entry["better"], entry["source"]) == ("%", "higher", "program_counter")


def test_a_traced_cpu_run_reads_zero(tmp_path):
    """A tiny traced run of the beam cell on the CPU: two profiled
    dispatches, each decode eager, so no ``decode.graph`` and a share of 0."""
    cmd = [sys.executable, "-c", CODE.format(here=HERE, pb=PB, name=NAME),
           "--workload", "capfilt_msrvtt_beam", "--seed", "3000000029", "--seconds", "8",
           "--trace", "1"]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stderr.split("SHARE ", 1)[1].splitlines()[0])
    assert out["calls"]["capfilt.dispatch"] == 2 and "decode.graph" not in out["calls"]
    assert out["value"] == 0.0


@pytest.mark.parametrize("graphs,share", [(4, 100.0), (3, 75.0), (0, 0.0)])
def test_reads_replays_per_dispatch(graphs, share, monkeypatch):
    from vidil_tpu_torch.utils import profiling

    totals = {"capfilt.dispatch": [4, 1.2], "decode.select": [64, 0.1]}
    if graphs:
        totals["decode.graph"] = [graphs, 0.01]
    monkeypatch.setattr(profiling, "_totals", totals)
    assert _reader().read({}) == share


def test_reads_nothing_without_a_dispatch_a_registry_or_decode_graphs(monkeypatch):
    from vidil_tpu_torch.utils import profiling

    mod = _reader()
    monkeypatch.setattr(profiling, "_totals", {})
    assert mod.read({}) is None  # tracing off: nothing recorded
    monkeypatch.setattr(profiling, "_totals", {"capfilt.dispatch": [4, 1.2]})
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".decode_graph") else find(name, *a))
    assert mod.read({}) is None  # a program without the decode graphs
    monkeypatch.setattr(importlib.util, "find_spec", find)
    monkeypatch.delattr(profiling, "span_totals")
    assert mod.read({}) is None  # a program without the registry
