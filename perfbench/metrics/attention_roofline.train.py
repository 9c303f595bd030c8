"""attention_roofline.train (layer: kernels): the least time of a train
step's attention calls (the reference's shapes through the frozen bound,
perfbench/core/peaks.py::attention_bound: each layer's forward with its
lse and its backward) over the profiled device time of the attention
kernels a step, in %."""

from perfbench.core import peaks, stats

KERNELS = ("flash_fwd_", "flash_bwd_", "rowsum_go", "scale_cast_dq")


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    s = ctx.trace.seconds(lambda n: any(k in n for k in KERNELS),
                          cats=("kernel",))
    if s <= 0:
        return None
    _, records = ctx.work(train=True)
    bound = 0.0
    for kind, shape in records:
        if kind == "attention":
            shape = (ctx.batch,) + shape[1:]
            bound += (peaks.attention_bound(shape, lse=True)[0]
                      + peaks.attention_bound(shape, backward=True)[0])
    return stats.roofline_pct(bound, s / ctx.trace.units)
