"""mfu.train (layer: model, the whole step): the reference's FLOPs an image
for a forward and backward (nothing recomputed), times the traced run's
img/s over its measured window (outside the profiled steps), over the
H100 SXM's 989 TFLOP/s of dense bf16, in %."""

from perfbench.core import peaks, stats


def read(ctx):
    if ctx.kind != "train" or not ctx.counts["steps"]:
        return None
    flops, _ = ctx.work(train=True)
    img_s = stats.rate(ctx.counts["images"], ctx.counts["seconds"])
    return stats.mfu_pct(flops, img_s, peaks.PEAK_BF16)
