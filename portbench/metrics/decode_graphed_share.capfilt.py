"""Share of the traced window's CapFilt chunks whose beam decode replayed
CUDA graphs (`vidil_tpu_torch/ops/decode_graph.py`): 100 times the calls
of the program's span ``vidil.decode.graph`` (one a replayed decode) over
the calls of ``vidil.capfilt.dispatch``. A ratio of the counts that the
program's registry keeps (`vidil_tpu_torch.utils.profiling.span_totals`,
which holds the profiled sub-window, the only time a profiler runs), not
of span times. None where the program has no such registry, recorded no
dispatch or has no decode graphs; 0 where it has them and replayed none
(a CPU run)."""

from __future__ import annotations

import importlib.util

SPAN, PER = "decode.graph", "capfilt.dispatch"


def read(t: dict):
    try:
        from vidil_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    if importlib.util.find_spec("vidil_tpu_torch.ops.decode_graph") is None:
        return None
    totals = span_totals()
    calls = totals.get(PER, (0, 0.0))[0]
    if not calls:
        return None
    return 100.0 * totals.get(SPAN, (0, 0.0))[0] / calls
