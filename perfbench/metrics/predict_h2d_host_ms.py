"""predict_h2d_host_ms (layer: predict): host ms a batch in the predict
function's input copy (`from_numpy` and the `.to(device, dtype)` of the
pageable batch, which holds the host for the copy): the port's span
`predict.h2d` in eval/reports.py::make_predict_fn, its calls in the traced
run's measured window summed over its batches. The host side of
eval_h2d_ms."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.window_ms(ctx, "predict.h2d", "predict")
