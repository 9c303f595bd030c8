"""train_img_s: images the train steps consumed in the window over the
window's seconds (host clock, from a synchronised start to the sync after
the last step)."""

from perfbench.core import stats


def read(ctx):
    if ctx.kind != "train":
        return None
    return stats.rate(ctx.counts["images"], ctx.counts["seconds"])
