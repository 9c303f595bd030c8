"""loader_wait_ms (layer: loader): host ms a step that the train loop
waited on the loader's queue: the port's span `loader.get` around the
consumer's `q.get()` in data/loader.py::NumpyLoader (once a batch, once
more at each epoch's end), its calls in the traced run's measured window
summed over its steps. The inside counterpart of train_data_wait_ms."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "loader.get", "train")
