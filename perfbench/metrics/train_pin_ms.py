"""train_pin_ms (layer: trainer and train step): host ms a step pinning
the batch: the port's span `batch.pin` around the `pin_memory()` calls of
core/mesh.py::shard_batch (through `Trainer._to_device`; a card only), its
calls in the traced run's measured window summed over its steps. A part of
train_dispatch_ms."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "batch.pin", "train")
