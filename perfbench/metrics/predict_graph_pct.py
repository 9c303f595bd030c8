"""predict_graph_pct (layer: predict): the share of the traced run's
measured window's batches whose forward replayed a CUDA graph, in %: the
port's span `predict.replay` inside `predict.forward` in
eval/reports.py::make_predict_fn, read from the port's tally as
perfbench/metrics/_spans.py reads the other spans.

The tally keeps each span's calls apart, so which forward held which replay
is not in it: the window's batches are the last n untraced calls of
`predict.forward` (n the window's batches), set-up's are the untraced calls
before them, and a batch key's capture (`predict.capture`) comes at its
first call, which set-up's warm batches make. The window's replays are then
the untraced replays less set-up's, set-up's being its calls less its
captures. None in a train cell, and where the port has no replay span (an
eager forward) or fewer untraced forwards than the window's batches, and
None where the tally does not add up this way (a capture inside the
window, replays outside [0, n]) rather than a share cut to fit."""

from perfbench.metrics import _spans


def read(ctx):
    if ctx.kind != "predict":
        return None
    n = ctx.counts.get(_spans.UNITS["predict"])
    tally = _spans.port_tally()
    if not n or tally is None or "predict.replay" not in tally:
        return None

    def untraced(name):
        return sum(not traced for _, traced in tally.get(name, ()))

    setup = untraced("predict.forward") - n
    captures = untraced("predict.capture")
    if setup < 0 or captures > setup:
        return None
    replays = untraced("predict.replay") - (setup - captures)
    if not 0 <= replays <= n:
        return None
    return 100.0 * replays / n
