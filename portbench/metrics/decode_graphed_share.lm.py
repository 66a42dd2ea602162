"""Share of the traced window's language-model chunks whose greedy decode
replayed CUDA graphs (`vidil_tpu_torch/ops/decode_graph.py`): 100 times the
calls of the program's span ``vidil.lm.graph`` (one a replayed decode) over
the calls of ``vidil.lm.dispatch``, from the program's registry
(`vidil_tpu_torch.utils.profiling.span_totals`, which holds the profiled
sub-window). None where the program recorded no dispatch."""

from __future__ import annotations

SPAN, PER = "lm.graph", "lm.dispatch"


def read(t: dict):
    try:
        from vidil_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = totals.get(PER, (0, 0.0))[0]
    if not calls:
        return None
    return 100.0 * totals.get(SPAN, (0, 0.0))[0] / calls
