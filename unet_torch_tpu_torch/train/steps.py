"""The single-head train and eval steps (counterpart of
unet_torch_tpu/train/steps.py::make_single_steps).

The JAX package threads a TrainState (params, batch_stats, opt_state, step)
through jit-compiled pure functions (train/state.py). The port has no such
object: the state is the model (parameters and BN buffers, updated in
place), the optimizer (its moments) and the trainer's step count.

`train_step(model, opt, x, y, lr, generator)` sets the LR on every param
group, binds `generator` to the model's dropouts, runs forward, loss,
backward and the optimizer step, and returns the loss as a 0-d device tensor
without syncing to the host. `eval_step(model, x, y)` returns (loss, score,
logits) under `no_grad`. x is NHWC in the compute dtype; the loss is f32.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from unet_torch_tpu_torch.losses import get_loss_fn
from unet_torch_tpu_torch.nn.dropout import set_dropout_generator
from unet_torch_tpu_torch.train.optim import clip_gradients


def make_single_steps(loss_type: str, accuracy_metric: str, num_classes: int,
                      relu_output: bool = False, fused_head: bool = False):
    """Steps for the single-head loop. `relu_output` (the `regression` model
    types) applies ReLU to the logits before the loss. `fused_head` is the
    JAX package's TPU layout of the loss and is ignored."""
    if fused_head:
        warnings.warn("fused_head=True is a TPU option of the JAX package; "
                      "the port ignores it", stacklevel=2)
    loss_fn = get_loss_fn(loss_type, num_classes)
    score_fn = get_loss_fn(accuracy_metric, num_classes)

    def head(out):
        return F.relu(out) if relu_output else out

    def train_step(model, opt, x, y, lr, generator):
        model.train()
        set_dropout_generator(model, generator)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(head(model(x)), y)
        loss.backward()
        clip_gradients(opt)
        opt.step()
        return loss.detach()

    def eval_step(model, x, y):
        model.eval()
        with torch.no_grad():
            out = model(x)
            return loss_fn(head(out), y), score_fn(head(out), y), out

    return train_step, eval_step
