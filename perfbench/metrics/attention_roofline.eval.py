"""attention_roofline.eval (layer: kernels): the least time of an eval
forward's attention calls (the reference's shapes through the frozen
bound, perfbench/core/peaks.py::attention_bound) over the profiled device
time of the attention forward kernels a forward, in %."""

from perfbench.core import peaks, stats

KERNELS = ("flash_fwd_",)


def read(ctx):
    if ctx.trace is None or ctx.kind != "predict":
        return None
    s = ctx.trace.seconds(lambda n: any(k in n for k in KERNELS),
                          cats=("kernel",))
    if s <= 0:
        return None
    _, records = ctx.work(train=False)
    bound = sum(peaks.attention_bound((ctx.batch,) + shape[1:])[0]
                for kind, shape in records if kind == "attention")
    return stats.roofline_pct(bound, s / ctx.trace.units)
