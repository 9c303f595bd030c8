"""predict_dispatch_ms (layer: predict): host ms a batch dispatching the
forward and its class argmax: the port's span `predict.forward` in
eval/reports.py::make_predict_fn, its calls in the traced run's measured
window summed over its batches."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "predict.forward", "predict")
