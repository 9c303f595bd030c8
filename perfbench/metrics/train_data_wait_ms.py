"""train_data_wait_ms (layer: loader): host ms a step spent in `next()` on
the train loader, summed over the traced run's measured window, over its
steps."""


def read(ctx):
    c = ctx.counts
    if ctx.kind != "train" or "data_wait_s" not in c or not c["steps"]:
        return None
    return 1e3 * c["data_wait_s"] / c["steps"]
