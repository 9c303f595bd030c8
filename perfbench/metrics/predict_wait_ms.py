"""predict_wait_ms (layer: predict): host ms a batch that the host waited
for the device and copied the class map back: the port's span
`predict.to_host` in eval/reports.py::_to_host, its calls in the traced
run's measured window summed over its batches."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "predict.to_host", "predict")
