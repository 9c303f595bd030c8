"""mfu.eval (layer: model, the whole forward): the reference's FLOPs an
image for a forward, times the traced run's img/s over its measured window
(outside the profiled batches), over the H100 SXM's 989 TFLOP/s of dense
bf16, in %."""

from perfbench.core import peaks, stats


def read(ctx):
    if ctx.kind != "predict" or not ctx.counts["images"]:
        return None
    flops, _ = ctx.work(train=False)
    img_s = stats.rate(ctx.counts["images"], ctx.counts["seconds"])
    return stats.mfu_pct(flops, img_s, peaks.PEAK_BF16)
