"""The single-head and the two-head train and eval steps (counterpart of
unet_torch_tpu/train/steps.py::make_single_steps and ::make_multitask_steps).

The JAX package threads a TrainState (params, batch_stats, opt_state, step)
through jit-compiled pure functions (train/state.py). The port has no such
object: the state is the model (parameters and BN buffers, updated in
place), the optimizer (its moments) and the trainer's step count.

`train_step(model, opt, x, y, lr, generator)` sets the LR on every param
group, binds `generator` to the model's dropouts, runs forward, loss,
backward and the optimizer step, and returns the loss as a 0-d device tensor
without syncing to the host. `eval_step(model, x, y)` returns (loss, score,
logits) under `no_grad`. x is NHWC in the compute dtype; the loss is f32.

The two-head steps take (y1, y2) and a `use_ratio` flag, a 0-d bool tensor on
the device, and return the combined loss and both head losses, all on the
device.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from unet_torch_tpu_torch.losses import get_loss_fn
from unet_torch_tpu_torch.nn.dropout import set_dropout_generator
from unet_torch_tpu_torch.train.optim import clip_gradients


def _warn_fused_head(fused_head: bool) -> None:
    if fused_head:
        warnings.warn("fused_head=True is a TPU option of the JAX package; "
                      "the port ignores it", stacklevel=3)


def make_single_steps(loss_type: str, accuracy_metric: str, num_classes: int,
                      relu_output: bool = False, fused_head: bool = False):
    """Steps for the single-head loop. `relu_output` (the `regression` model
    types) applies ReLU to the logits before the loss. `fused_head` is the
    JAX package's TPU layout of the loss and is ignored."""
    _warn_fused_head(fused_head)
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


def make_multitask_steps(loss_type: str, num_classes: int,
                         combine: str = "sum", fused_head: bool = False):
    """Steps for the two-head loops. Both heads pass through ReLU before the
    loss. The per-head loss is `loss_type` for `combine="sum"` and fixed
    `mse` for `"uncertainty"` and `"ratio"`.

    `"uncertainty"` reads the model's `log_vars`, a (2,) parameter that
    rides the same optimizer (UNetMultitask.add_log_vars):
    sum_i l_i / (2 sigma_i^2) + log sigma_i. `"ratio"` multiplies l1 + l2 by
    1 + 10 * mean |ratio_gt - ratio_pred| of the per-image count sums once
    `use_ratio` is true; a batch image whose two counts are both zero gives
    0/0 = NaN there, as in the JAX package."""
    if combine not in ("sum", "uncertainty", "ratio"):
        raise ValueError(f"Invalid combine {combine!r}")
    _warn_fused_head(fused_head)
    head_loss = get_loss_fn(loss_type if combine == "sum" else "mse",
                            num_classes)

    def combined(model, o1, o2, y1, y2, use_ratio):
        l1, l2 = head_loss(o1, y1), head_loss(o2, y2)
        if combine == "uncertainty":
            stds = torch.exp(model.log_vars) ** 0.5
            coeff = 1.0 / (2.0 * stds ** 2)
            loss = (coeff[0] * l1 + torch.log(stds[0])
                    + coeff[1] * l2 + torch.log(stds[1]))
        elif combine == "ratio":
            c1_gt, c2_gt = (torch.sum(y.float(), dim=(1, 2)) for y in (y1, y2))
            c1_pr, c2_pr = (torch.sum(o[..., 0].float(), dim=(1, 2))
                            for o in (o1, o2))
            ratio_acc = torch.mean(torch.abs(c1_gt / (c1_gt + c2_gt)
                                             - c1_pr / (c1_pr + c2_pr)))
            loss = torch.where(use_ratio,
                               (l1 + l2) * (1.0 + 10.0 * ratio_acc), l1 + l2)
        else:
            loss = l1 + l2
        return loss, l1, l2

    def train_step(model, opt, x, y1, y2, lr, generator, use_ratio):
        model.train()
        set_dropout_generator(model, generator)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        o1, o2 = model(x)
        loss, l1, l2 = combined(model, F.relu(o1), F.relu(o2), y1, y2,
                                use_ratio)
        loss.backward()
        clip_gradients(opt)
        opt.step()
        return loss.detach(), l1.detach(), l2.detach()

    def eval_step(model, x, y1, y2, use_ratio):
        model.eval()
        with torch.no_grad():
            o1, o2 = model(x)
            o1, o2 = F.relu(o1), F.relu(o2)
            return (*combined(model, o1, o2, y1, y2, use_ratio), o1, o2)

    return train_step, eval_step
