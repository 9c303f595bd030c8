"""eval_img_s: images whose class maps reached the host in the window over
the window's seconds (host clock)."""

from perfbench.core import stats


def read(ctx):
    if ctx.kind != "predict":
        return None
    return stats.rate(ctx.counts["images"], ctx.counts["seconds"])
