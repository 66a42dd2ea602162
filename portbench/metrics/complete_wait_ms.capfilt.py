"""Host milliseconds per chunk of the traced window in the host's block on
the chunk's device results at the top of `complete_chunk` (the early
readback's event, or the first read): the program's span
``vidil.capfilt.wait`` over the calls of ``vidil.capfilt.complete``
(`vidil_tpu_torch.utils.profiling.span_totals`, which holds the profiled
sub-window, the only time a profiler runs). None where the program has no
such spans."""

from __future__ import annotations

SPAN, PER = "capfilt.wait", "capfilt.complete"


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
