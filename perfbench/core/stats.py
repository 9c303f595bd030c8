"""The metric arithmetic, kept here so that no edit of the program moves it:
a rate over the window, a percentile over all samples, the busy time of a
set of device intervals, the idle gaps between them, an idle share, a
roofline share and a model-FLOPs utilisation."""

from __future__ import annotations

import math


def rate(count: float, seconds: float) -> float:
    """Work done over the seconds it took: the whole window's."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of every sample, linearly interpolated between
    the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def busy(intervals, window) -> float:
    """Time inside `window` (start, end) covered by at least one interval."""
    w0, w1 = window
    return sum(max(0.0, min(e, w1) - max(s, w0)) for s, e in merge(intervals))


def gaps(intervals, window):
    """The idle (start, end) stretches of `window` that no interval
    covers, in time order."""
    w0, w1 = window
    out, t = [], w0
    for s, e in merge(intervals):
        if e <= w0 or s >= w1:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return out


def idle_pct(intervals, window) -> float:
    """Share of `window` in which no interval runs, in %."""
    length = window[1] - window[0]
    return 100.0 * (1.0 - busy(intervals, window) / length)


def idle_share_pct(busy_per_unit: float, time_per_unit: float) -> float:
    """Share of a unit's time (a step or a batch, taken over the measured
    window) in which the device is not busy, from the busy time a unit of
    the device profile, in %; below 0 where a profiled unit kept the
    device busy longer than a unit of the window took (not clipped)."""
    return 100.0 * (1.0 - busy_per_unit / time_per_unit)


def roofline_pct(bound_s: float, measured_s: float) -> float:
    """The least time the chip could take over the time it took, in %."""
    return 100.0 * bound_s / measured_s


def mfu_pct(flops_per_item: float, items_per_s: float, peak: float) -> float:
    """Model FLOPs a second over the chip's peak, in %."""
    return 100.0 * flops_per_item * items_per_s / peak
