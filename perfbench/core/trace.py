"""The traced sub-windows, read back from torch.profiler's exported chrome
traces, on the device's clock, in seconds.

Two profiles of the same number of steps or batches, one after the other:
- the device profile records the device's activity alone (kernels,
  copies, memsets) and no host operation, so that the host runs at about
  its untraced pace; its window opens and closes with a one-element fill
  issued after a synchronise. Busy and idle time, each operation's device
  time and the breakdown's device operations come from it;
- the host profile records the host's operations too, each call into a
  layer inside a named span of the harness, and slows the host; it gives
  only the breakdown's idle gaps, each labelled by the span the host was
  in."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

from perfbench.core import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
SPANS = ("loader.next", "trainer.to_device", "step", "inputs", "predict",
         "to_host")


def _device_ops(events):
    """(name, cat, start, end) of the device's operations."""
    out = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS:
            start = float(e["ts"]) * 1e-6
            out.append((e["name"], e["cat"], start,
                        start + float(e["dur"]) * 1e-6))
    return out


class Trace:
    def __init__(self, device_events, host_events, units: int,
                 host_s: float):
        self.units = units
        self.host_s = host_s  # the device profile's units on the host clock
        self.ops = _device_ops(device_events)
        if not self.ops:
            raise RuntimeError("the device profile holds no device operation")
        # the window's opening and closing fills are the first and last
        self.window = (min(s for *_, s, _ in self.ops),
                       max(e for *_, e in self.ops))
        self.host_ops = _device_ops(host_events)
        self.spans = defaultdict(list)
        for e in host_events:
            if (e.get("ph") == "X" and "dur" in e
                    and e.get("cat") == "user_annotation"):
                start = float(e["ts"]) * 1e-6
                self.spans[e["name"]].append(
                    (start, start + float(e["dur"]) * 1e-6))
        if not self.spans[WINDOW]:
            raise RuntimeError("the host profile holds no window span")
        self.host_window = self.spans[WINDOW][0]

    def intervals(self, match=None, cats=DEVICE_CATS):
        return [(s, e) for n, c, s, e in self.ops
                if c in cats and (match is None or match(n))]

    def seconds(self, match=None, cats=DEVICE_CATS) -> float:
        """Device time of the matching operations inside the window."""
        w0, w1 = self.window
        return sum(max(0.0, min(e, w1) - max(s, w0))
                   for s, e in self.intervals(match, cats))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def host_window_s(self) -> float:
        return self.host_window[1] - self.host_window[0]

    @property
    def busy_s(self) -> float:
        return stats.busy(self.intervals(), self.window)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (device profile), and
        the idle time by what the host was doing (host profile: the
        innermost span of the harness around each idle stretch's middle,
        else "other")."""
        by_op = defaultdict(float)
        w0, w1 = self.window
        for n, _, s, e in self.ops:
            by_op[n[:120]] += max(0.0, min(e, w1) - max(s, w0))
        by_host = defaultdict(float)
        for g0, g1 in stats.gaps([(s, e) for *_, s, e in self.host_ops],
                                 self.host_window):
            mid, label, inner = (g0 + g1) / 2, "other", None
            for name in SPANS:
                for s, e in self.spans.get(name, ()):
                    if s <= mid <= e and (inner is None or e - s < inner):
                        label, inner = name, e - s
            by_host[label] += g1 - g0

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}


def _events(prof, workdir: str, name: str) -> list:
    path = os.path.join(workdir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return events


def run(profile_fn, workdir: str) -> Trace:
    """`profile_fn(span)` under the device profile, then again under the
    host profile inside the window span; both run as many units."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mark = torch.zeros(1, device="cuda")  # opens the window
        t = time.perf_counter()
        units = profile_fn(no_span)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        mark.fill_(1.0)  # closes it
        torch.cuda.synchronize()
    device_events = _events(prof, workdir, "device.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            profile_fn(record_function)
    host_events = _events(prof, workdir, "host.json")
    return Trace(device_events, host_events, units, host_s)


def no_span(name):
    return contextlib.nullcontext()
