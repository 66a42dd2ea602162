"""What every driver shares: the host clock, spans around calls into the
program, the traced sub-window's profile, and the tail statistic.

Spans (`Spans`) are recorded from the benchmark's side of a call: the host
seconds a call takes, and, for calls whose device work is wanted, the
milliseconds between two CUDA events recorded around it. In a traced run
each span is also a `torch.profiler.record_function` range named
``portbench.<span>``, so the profile can say what the host was doing
while the device sat idle (`Profile.summary`).
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch

clock = time.perf_counter


def quartiles_ms(seconds) -> list[float]:
    """Quartiles of a list of seconds, in milliseconds (diagnostics)."""
    return [round(q * 1e3, 3) for q in statistics.quantiles(seconds, n=4)] if len(seconds) > 1 \
        else [round(s * 1e3, 3) for s in seconds]


def freeze_heap() -> None:
    """Move everything set-up made out of the garbage collector's way, so
    its full collections in the window do not walk the traffic's pool."""
    import gc

    gc.collect()
    gc.freeze()


def p90(values) -> float:
    """The 90th percentile (inclusive quantiles)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=10, method="inclusive")[8]


class Spans:
    """Host seconds and CUDA-event milliseconds of wrapped calls, by name."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.cuda = device.type == "cuda"
        self.host = defaultdict(list)
        self._events = defaultdict(list)

    def host_span(self, name, fn):
        """`fn` with its host seconds recorded under `name` (traced runs)."""
        if not self.on:
            return fn
        label = f"portbench.{name}"

        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                t0 = clock()
                out = fn(*a, **k)
                self.host[name].append(clock() - t0)
            return out

        return wrapped

    def device_span(self, name, fn):
        """`fn` with CUDA events recorded before and after it under `name`
        (traced runs on the card): the device milliseconds from the point
        the stream reaches the call's first work to the end of its last."""
        if not (self.on and self.cuda):
            return fn

        def wrapped(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self._events[name].append((start, end))
            return out

        return wrapped

    def clear(self) -> None:
        self.host.clear()
        self._events.clear()

    def device_ms(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self._events.items()}

    def host_ms(self) -> dict:
        return {k: [s * 1e3 for s in v] for k, v in self.host.items()}


class Profile:
    """torch.profiler over a sub-window of a traced run (CPU and CUDA
    activity), kept in memory."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.cuda = device.type == "cuda"
        self.prof = profile(activities=acts)
        self.window_s = None
        self.units = 0

    @staticmethod
    def warm_up(device: torch.device) -> None:
        """Start and stop the profiler once (set-up), so that its first
        start, which takes seconds on the card, falls outside the window."""
        with Profile(device):
            torch.ones(8, device=device).sum()

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = clock() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        """kernels: [(name, start_us, end_us)] of device work; host:
        [(name, start_us, end_us)] of the portbench spans; busy_s: the union
        of the kernel intervals; gaps labelled by the span the host was in
        when the device went idle."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        # a record_function range also shows as a device-side row spanning
        # its kernels under the host range's name: not device work
        host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
        kernels, host = [], []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA and e.name not in host_names:
                kernels.append((e.name, tr.start, tr.end))
            elif e.device_type != DeviceType.CUDA and e.name.startswith("portbench."):
                host.append((e.name[len("portbench."):], tr.start, tr.end))
        kernels.sort(key=lambda k: k[1])
        merged = []
        for _, s, e in kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_us = sum(e - s for s, e in merged)
        by_name = defaultdict(float)
        for name, s, e in kernels:
            by_name[name] += (e - s) * 1e-6
        idle = defaultdict(float)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            idle[_innermost(host, e0)] += (s1 - e0) * 1e-6
        return {"kernels": kernels, "by_name": dict(by_name), "busy_s": busy_us * 1e-6,
                "window_s": self.window_s, "units": self.units, "idle_by_span": dict(idle)}


def _innermost(host, t) -> str:
    best, width = "harness", float("inf")
    for name, s, e in host:
        if s <= t < e and e - s < width:
            best, width = name, e - s
    return best


def breakdown(summary: dict) -> dict:
    """The traced line's breakdown: the ten device operations that took
    most time, and the idle time by what the host was doing."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def sum_kernels(summary: dict, match) -> tuple[float, int]:
    """Seconds and launches of the kernels whose names `match` accepts."""
    sel = [(e - s) * 1e-6 for name, s, e in summary["kernels"] if match(name)]
    return sum(sel), len(sel)


def device_info(device: torch.device, world: int, peak: int) -> dict:
    """The result line's `device`: the card's name, the cards used, the
    peak allocated bytes on the fullest one."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": world,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": world, "memory_peak_bytes": peak}
