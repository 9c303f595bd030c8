"""train_dispatch_ms (layer: trainer and train step, host side): host ms a
step spent in `Trainer._to_device` and the train step's call (its enqueue;
the host waits here only where the device's queue is full), summed over
the traced run's measured window, over its steps."""


def read(ctx):
    c = ctx.counts
    if ctx.kind != "train" or "dispatch_s" not in c or not c["steps"]:
        return None
    return 1e3 * c["dispatch_s"] / c["steps"]
