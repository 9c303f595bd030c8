"""idle_dispatch_pct.eval (layer: device): the share of the host profile's
idle device time that falls while the host dispatches the forward (the
port's span `predict.forward`), in %: each idle stretch, formed as
`Trace.breakdown` forms them, goes to the span around its middle. The idle
time that the forward's dispatch leaves, which CUDA graphs can take, apart
from the input copy's; a part of the breakdown's `predict`."""

from perfbench.metrics import _spans

SPANS = ("predict.forward",)


def read(ctx):
    return _spans.idle_inside_pct(ctx, SPANS, "predict")
