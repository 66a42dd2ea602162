"""Windowed metric tracking + iteration logging: the port's own copy of
``vidil_tpu/utils/logging.py`` (reference: utils.py:34-183), with the peak
CUDA memory of ``torch.cuda`` in the log line when the run is on a card.
`MetricLogger.synchronize_between_processes` sums every meter's count and
total over the ranks in fp64 (the window stays local), so ``global_avg``
is the world's.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np

from vidil_tpu_torch.utils.dist import is_dist_avail_and_initialized

__all__ = ["SmoothedValue", "MetricLogger"]


class SmoothedValue:
    """Track a series of values; expose smoothed window stats and global avg."""

    def __init__(self, window_size: int = 20, fmt: str | None = None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self) -> None:
        """All-reduce count/total across processes (window stays local)."""
        if not is_dist_avail_and_initialized():
            return
        import torch
        import torch.distributed as dist

        from vidil_tpu_torch.utils.dist import collective_device

        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=collective_device())
        dist.all_reduce(t)
        t = t.cpu()
        self.count = int(t[0])
        self.total = float(t[1])

    @property
    def median(self) -> float:
        return float(np.median(np.asarray(self.deque)))

    @property
    def avg(self) -> float:
        return float(np.mean(np.asarray(self.deque, dtype=np.float32)))

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque)

    @property
    def value(self) -> float:
        return self.deque[-1]

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


def _device_mem_gb() -> float | None:
    """Peak CUDA memory allocated by this process in GB; None off a card."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.max_memory_allocated() / (1024.0**3)


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = v.item()
            assert isinstance(v, (float, int)), f"metric {k} must be scalar"
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq: int, header: str | None = None):
        """Yield from ``iterable`` printing iter/data timing stats + ETA."""
        i = 0
        header = header or ""
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        space_fmt = ":" + str(len(str(len(iterable)))) + "d"
        log_parts = [
            header,
            "[{0" + space_fmt + "}/{1}]",
            "eta: {eta}",
            "{meters}",
            "time: {time}",
            "data: {data}",
        ]
        mem = _device_mem_gb()
        if mem is not None:
            log_parts.append("mem: {memory:.1f}GB")
        log_msg = self.delimiter.join(log_parts)
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == len(iterable) - 1:
                eta_seconds = iter_time.global_avg * (len(iterable) - i)
                eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                kwargs = dict(
                    eta=eta_string,
                    meters=str(self),
                    time=str(iter_time),
                    data=str(data_time),
                )
                if mem is not None:
                    kwargs["memory"] = _device_mem_gb() or 0.0
                print(log_msg.format(i, len(iterable), **kwargs))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        total_time_str = str(datetime.timedelta(seconds=int(total_time)))
        print(f"{header} Total time: {total_time_str} ({total_time / max(len(iterable),1):.4f} s / it)")
