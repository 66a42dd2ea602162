"""Tracing and profiling helpers.

Counterpart of ``vidil_tpu/utils/profiling.py``. The reference's
observability is wall-clock timers and CUDA max-memory in MetricLogger
(reference: utils.py:139-183); the port adds device traces through
`torch.profiler` (the CUPTI tracer), spans at the program's stages, the
allocator's memory statistics, and `device_profile`, the per-kernel device
time of a function.

Spans (`annotate`) mark the stages of a CapFilt chunk, of the beam decode
and of a train step. A span is on exactly while a torch profiler
runs in the process (`torch.profiler.profile`, as `trace` starts one, or
`torch.autograd.profiler.emit_nvtx`). Then ``annotate("decode.step")``
enters a `record_function` range named ``vidil.decode.step``, which the
profiler's trace holds on the kernels' clock (and `emit_nvtx` turns into an
NVTX range), and adds its host seconds and one call to a registry by stage
(`span_totals`, `reset_spans`). Off, a span is one check of the profiler's
state and a shared context that does nothing. Spans are entered on the
thread that calls the program, never inside autograd's backward.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
from torch.autograd import _profiler_enabled

SPAN_PREFIX = "vidil."

_OFF = contextlib.nullcontext()
_totals: dict[str, list] = {}  # stage -> [calls, host seconds]


class _Span:
    """An entered span: its profiler range and its host seconds."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        total = _totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += dt
        return False


def annotate(name: str):
    """The span of stage `name` (see the module's docstring): with a
    profiler on, the range ``vidil.<name>`` and a registry entry; off, the
    shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def span_totals() -> dict[str, tuple[int, float]]:
    """{stage: (calls, host seconds)} of the spans entered since the last
    `reset_spans` (or `trace`)."""
    return {k: (c, s) for k, (c, s) in _totals.items()}


def reset_spans() -> None:
    _totals.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region: host ops, the program's
    spans and, where CUDA is available, its kernels. On exit it is written
    to `log_dir` as a Chrome trace (``*.pt.trace.json``), which
    ui.perfetto.dev and TensorBoard's profiler plugin read. The span
    registry is emptied on entry, so `span_totals` then holds the region's.
    Yields the profiler (its ``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def device_memory_stats() -> dict:
    """Current and peak bytes the caching allocator holds for tensors on
    the current GPU, and the GPU's total memory (`mem_get_info`); {} without
    CUDA."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": total}


def device_profile(fn, reps: int = 5):
    """torch.profiler over `reps` calls of fn after one warm-up call: the
    device ms per call (its kernels' device time, summed: one stream) and,
    per kernel name, [ms per call, launches per call]. Per name, the mean
    of the launches it recorded times its launches per call, the recorded
    count over `reps` rounded up (the profiler can drop a few launches of a
    window); a window that recorded no kernel is profiled again, twice at
    most. Needs CUDA."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key for e in events if e.device_type != DeviceType.CUDA}
        kernels = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and e.key not in host and e.count:
                per_call = math.ceil(e.count / reps)
                kernels[e.key] = [e.self_device_time_total / 1e3 / e.count * per_call, per_call]
        if kernels:
            break
    return sum(ms for ms, _ in kernels.values()), kernels
