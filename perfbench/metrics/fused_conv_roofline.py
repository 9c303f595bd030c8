"""fused_conv_roofline (layer: kernels): the least time of an eval
forward's conv3x3 + BN + ReLU calls (the reference's shapes through the
frozen bound, perfbench/core/peaks.py::conv_bound) over the profiled
device time of the fused conv's kernels a forward, in %."""

from perfbench.core import peaks, stats

KERNELS = ("conv3x3_bn_relu_wgmma", "conv3x3_bn_relu_narrow",
           "conv3x3_bn_relu_pipe", "conv3x3_bn_relu_reg")


def read(ctx):
    if ctx.trace is None or ctx.kind != "predict":
        return None
    s = ctx.trace.seconds(lambda n: any(k in n for k in KERNELS),
                          cats=("kernel",))
    if s <= 0:
        return None
    _, records = ctx.work(train=False)
    shapes = [shape for kind, shape in records if kind == "conv_bn_relu"]
    bound, _ = peaks.conv_bound(shapes, ctx.batch)
    return stats.roofline_pct(bound, s / ctx.trace.units)
