"""train_backward_ms (layer: trainer and train step): host ms a step in
`loss.backward()` and the replicated gradients' average: the port's span
`step.backward` in train/steps.py::make_single_steps, its calls in the
traced run's measured window summed over its steps. A part of
train_dispatch_ms."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "step.backward", "train")
