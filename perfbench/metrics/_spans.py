"""The port's spans as the per-layer metrics read them: not a metric, the
reading that the span metrics share.

The port times its own host work in named spans
(unet_torch_tpu_torch/utils/debug.py::span): every call's host ns goes to an
in-process tally, tagged with whether a profiler recorded when it opened,
and while one records the span is also a range in the profile. A port
without that tally (an older commit) gives every reader None.

- `window_ms`: the traced run's measured window, read from the tally: the
  span's last n calls that no profiler recorded, n the window's steps
  (train) or batches (predict); set-up's calls come before them and the
  two profiles' calls are tagged. Their host ns summed, over n, in ms.
- `idle_inside_pct`: the host profile's idle device time (its stretches
  formed as `Trace.breakdown` forms them) whose stretch's middle lies inside
  one of the named spans, over all of it, in %."""

from __future__ import annotations

from perfbench.core import stats

UNITS = {"train": "steps", "predict": "batches"}


def port_tally():
    """{span: [(host ns, traced), ...]} of the port, or None."""
    from unet_torch_tpu_torch.utils import debug

    read = getattr(debug, "tally", None)
    return None if read is None else read()


def window_ms(ctx, name: str, kind: str):
    """ms a unit of span `name` over the measured window; None in a cell of
    another kind, or where the port has no such span or fewer untraced
    calls than the window's units."""
    if ctx.kind != kind:
        return None
    n = ctx.counts.get(UNITS[kind])
    tally = port_tally()
    if not n or tally is None:
        return None
    calls = [ns for ns, traced in tally.get(name, ()) if not traced]
    if len(calls) < n:
        return None
    return 1e-6 * sum(calls[-n:]) / n


def idle_inside_pct(ctx, names, kind: str):
    """% of the host profile's idle device time inside spans `names`; None
    in a cell of another kind, without a trace or where the host profile
    holds none of those spans."""
    if ctx.trace is None or ctx.kind != kind:
        return None
    tr = ctx.trace
    spans = [iv for name in names for iv in tr.spans.get(name, ())]
    if not spans:
        return None
    gaps = stats.gaps([(s, e) for *_, s, e in tr.host_ops], tr.host_window)
    total = sum(g1 - g0 for g0, g1 in gaps)
    if total <= 0:
        return None
    inside = sum(g1 - g0 for g0, g1 in gaps
                 if any(s <= (g0 + g1) / 2 <= e for s, e in spans))
    return 100.0 * inside / total
