"""Tracing and profiling helpers.

Counterpart of ``vidil_tpu/utils/profiling.py``. The reference's
observability is wall-clock timers and CUDA max-memory in MetricLogger
(reference: utils.py:139-183); the port adds device traces through
`torch.profiler` (the CUPTI tracer), named ranges that show in them and in
an NVTX timeline, a step timer, the allocator's memory statistics, and
`device_profile`, the per-kernel device time of a function.
"""

from __future__ import annotations

import contextlib
import math
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region: host ops and, where CUDA is
    available, its kernels. On exit it is written to `log_dir` as a Chrome
    trace (``*.pt.trace.json``), which ui.perfetto.dev and TensorBoard's
    profiler plugin read. Yields the profiler (its ``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """A named region that shows in `trace`'s output (`record_function`)
    and, where CUDA is available, as an NVTX range."""
    import torch
    from torch.profiler import record_function

    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class StepTimer:
    """Wall-clock step timing with warmup exclusion and a one-line summary."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self, items_per_step: float = 1.0) -> str:
        if not self.times:
            return "no timed steps"
        return (f"{len(self.times)} steps, mean {self.mean*1000:.1f} ms/step, "
                f"{items_per_step / self.mean:.2f} items/s")


def device_memory_stats() -> dict:
    """Current and peak bytes the caching allocator holds for tensors on
    the current GPU, and the GPU's total memory (`mem_get_info`); {} without
    CUDA."""
    import torch

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
    import torch
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
