"""eval_h2d_ms (layer: predict): device ms a batch of host-to-device copies
in the profiled batches."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "predict":
        return None
    s = ctx.trace.seconds(lambda n: "HtoD" in n, cats=("gpu_memcpy",))
    return 1e3 * s / ctx.trace.units if s > 0 else None
