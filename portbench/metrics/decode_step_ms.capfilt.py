"""Host milliseconds per chunk of the traced window in the decoder's one-
token passes (`step_fn`: the MED's self and cross attention over the
cache, the LM head): the program's span ``vidil.decode.step`` over the
calls of ``vidil.capfilt.dispatch``
(`vidil_tpu_torch.utils.profiling.span_totals`, which holds the profiled
sub-window, the only time a profiler runs). None where the program has no
such spans."""

from __future__ import annotations

SPAN, PER = "decode.step", "capfilt.dispatch"


def read(t: dict):
    try:
        from vidil_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = totals.get(PER, (0, 0.0))[0]
    if not calls or SPAN not in totals:
        return None
    return 1e3 * totals[SPAN][1] / calls
