"""idle_dispatch_pct.train (layer: device): the share of the host profile's
idle device time that falls while the host is inside the train step's three
phases (the port's spans `step.forward`, `step.backward`, `step.optimizer`),
in %: each idle stretch, formed as `Trace.breakdown` forms them, goes to the
span around its middle. The idle time that the step's dispatch leaves,
which CUDA graphs can take; a part of the breakdown's `step`."""

from perfbench.metrics import _spans

SPANS = ("step.forward", "step.backward", "step.optimizer")


def read(ctx):
    return _spans.idle_inside_pct(ctx, SPANS, "train")
