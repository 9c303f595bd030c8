"""loader_fetch_ms (layer: loader): host ms a step that the loader's
producer thread spent building batches (read, decode and augment through
its pool, then stack): the port's span `loader.fetch` around
data/loader.py::NumpyLoader._fetch, its calls in the traced run's measured
window summed over its steps. Beside loader_wait_ms: whether the producer
is slower than a step, or starts late each epoch."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "loader.fetch", "train")
