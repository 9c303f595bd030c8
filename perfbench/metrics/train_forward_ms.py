"""train_forward_ms (layer: trainer and train step): host ms a step in the
train step's set-up, forward and loss: the port's span `step.forward` in
train/steps.py::make_single_steps, its calls in the traced run's measured
window summed over its steps. A part of train_dispatch_ms."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "step.forward", "train")
