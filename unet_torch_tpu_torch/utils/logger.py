"""Throughput and ETA logging (the port's copy of
unet_torch_tpu/utils/logger.py, which imports only `time` and
`collections`; tests/test_torch_port_copies.py holds the two equal).

SmoothedValue tracks a windowed median / average of a scalar series;
MetricLogger.log_every wraps an iterable with the time of each iteration,
the ETA and the meters' values. It reads no device memory (the original's
docstring promises readouts its code never makes).
"""

from __future__ import annotations

import time
from collections import defaultdict, deque


class SmoothedValue:
    """Window-smoothed scalar (ref :34-85)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with ETA (ref :166-253)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = f"eta: {eta:.0f}s"
                else:
                    eta_str = ""
                self.print_fn(self.delimiter.join(filter(None, [
                    header, f"[{i}{f'/{total}' if total else ''}]", eta_str,
                    str(self), f"time: {iter_time}"])))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(f"{header} Total time: {elapsed:.1f}s "
                      f"({elapsed / max(i, 1):.4f} s/it)")
