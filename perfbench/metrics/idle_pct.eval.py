"""idle_pct.eval (layer: device): the share of a batch's time in which no
device operation runs, in %: the device profile's busy time (the union of
the kernels', copies' and memsets' intervals) a batch, over the time a
batch took in the run's measured window (host clock). The profiler's own
cost on the host, which lengthens the profiled batches, is thus left out.
"""

from perfbench.core import stats


def read(ctx):
    if (ctx.trace is None or ctx.kind != "predict"
            or not ctx.counts["batches"]):
        return None
    return stats.idle_share_pct(
        ctx.trace.busy_s / ctx.trace.units,
        ctx.counts["seconds"] / ctx.counts["batches"])
