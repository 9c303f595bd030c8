"""train_step_p95_ms: the 95th percentile, over every step of the window, of
the time between consecutive steps' end events (CUDA events recorded on
the step's stream after each step call, no per-step synchronise; the
first interval starts at an event recorded at the window's start)."""

from perfbench.core import stats


def read(ctx):
    if ctx.kind != "train" or not ctx.counts["step_ms"]:
        return None
    return stats.percentile(ctx.counts["step_ms"], 95)
