"""Host milliseconds per step of the traced window in AdamW: clearing the old
gradients and its step: the program's span ``vidil.train.optimizer`` over
the calls of ``vidil.train.step``
(`vidil_tpu_torch.utils.profiling.span_totals`, which holds the profiled
sub-window, the only time a profiler runs). None where the program has no
such spans."""

from __future__ import annotations

SPAN, PER = "train.optimizer", "train.step"


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
