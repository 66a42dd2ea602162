"""The four-chip caption cell, `caption_ft_msrvtt_dp4`, as the benchmark
lists it: a whole tiny run over four gloo ranks on the CPU (`rank_cpu.py`)
reads as one process on the global batch, and with the gradient
all-reduce left out reads not correct."""

from __future__ import annotations

from test_portbench_runs import tiny_run

CELL = "caption_ft_msrvtt_dp4"


def test_dp4_over_four_ranks_is_correct_and_needs_the_exchange(tmp_path):
    sound, _ = tiny_run(CELL, tmp_path=tmp_path)
    assert sound["correct"] is True and sound["device"]["count"] == 4
    broken, _ = tiny_run(CELL, "exchange", tmp_path=tmp_path)
    assert broken["correct"] is False
    assert broken["checks"]["grad_gap"]["value"] > 10 * sound["checks"]["grad_gap"]["value"]
