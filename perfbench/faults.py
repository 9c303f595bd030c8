"""Faults planted under the timed path, for the tests that see `correct`
come out false and for the fault readings that set the train cells' upper
limits. No run of the benchmark plants one.

- `unchanged`: the train step computes its loss but leaves the model and
  the optimizer as they were;
- `half_batch`: the train step takes the first half of its batch, its
  loss the mean over that half;
- `altered`: one image's class map of each batch is changed where it is
  produced (each class moved to the next).

These wrap the calls of loops/train.py and loops/predict.py, whose `FAULTS`
name them; a loop module of another driver exports wrappers of its own
call."""

from __future__ import annotations

import torch


def unchanged(train_step):
    def step(model, opt, x, y, lr, generator):
        params = [p.detach().clone() for p in model.parameters()]
        loss = train_step(model, opt, x, y, lr, generator)
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), params):
                p.copy_(p0)
        opt.state.clear()
        return loss
    return step


def half_batch(train_step):
    def step(model, opt, x, y, lr, generator):
        n = x.shape[0] // 2
        return train_step(model, opt, x[:n], y[:n], lr, generator)
    return step


def altered(predict, classes: int = 3):
    def serve(xs):
        out = predict(xs).clone()
        out[0] = (out[0] + 1) % classes
        return out
    return serve
