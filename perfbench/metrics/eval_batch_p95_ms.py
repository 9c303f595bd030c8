"""eval_batch_p95_ms: the 95th percentile, over every batch of the window,
of the host time from the batch's predict call to its class map as numpy
on the host."""

from perfbench.core import stats


def read(ctx):
    if ctx.kind != "predict" or not ctx.counts["batch_ms"]:
        return None
    return stats.percentile(ctx.counts["batch_ms"], 95)
