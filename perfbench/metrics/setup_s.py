"""setup_s: seconds from the start of the run's process to the start of the
measured window (imports, CUDA start, inputs, weights, kernel loads or
builds, warm-up; the train cells' first epoch)."""


def read(ctx):
    return ctx.setup_s
