"""BatchNorm over the global batch of a data-parallel step.

In the JAX package's GSPMD step the train-mode BatchNorm statistics are the
global batch's. Under DistributedDataParallel each rank holds a share of it,
so `SyncBatchNorm2d` all-reduces over the data group, in f32 (f64 for an
f64 input), [sum, count]
for the mean, then the sum of squared deviations from it for the biased
variance: the value that flax's BatchNorm uses for the JAX package,
E[x^2] - E[x]^2, taken in two passes. (Flax's one-pass form cancels in f32
where the mean is large against the spread: on UNet-64 at 512x512 it moved
the deepest layers' gradients 1-2% from the one-process step's.) The
running statistics follow torch's update with the unbiased variance over
the global count, as the one-process BatchNorm2d keeps them; every rank
computes them from the same sums, so they stay bitwise equal across ranks.
The backward all-reduces sum(dy) and sum(dy x_hat) over the group, as
torch's SyncBatchNorm does (`_SyncBatchNorm`). Eval mode is BatchNorm2d's
(the UNet blocks fold the running statistics into the fused conv).

torch's own SyncBatchNorm is not used: it takes CUDA tensors only and
gathers with `all_gather`, which gloo does not run on CUDA tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from unet_torch_tpu_torch.core.dist import all_reduce_


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the ranks of `group`, in f32
    (f64 for an f64 input).

    Forward: the mean from the all-reduced [sum, count] of the whole batch
    (n elements a channel), then the biased variance from the all-reduced
    sum of squared deviations. Backward: torch's
    SyncBatchNorm's, dx = w / sigma (dy - sum(dy) / n - x_hat
    sum(dy x_hat) / n) with both sums all-reduced over the group, and the
    weight's and bias's gradients from this rank's share alone (the mean
    over the ranks that DistributedDataParallel takes sums them), one
    all-reduce where autograd through the forward would take two."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        stats = all_reduce_(torch.cat([xf.sum(dims), count]), group)
        n = stats[-1]
        mean = stats[:c] / n
        shape = (1, c, 1, 1)
        centred = xf - mean.view(shape)
        var = all_reduce_((centred * centred).sum(dims), group) / n
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        y = centred * (invstd * weight).view(shape) + bias.view(shape)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        shape = (1, c, 1, 1)
        dims = (0, 2, 3)
        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        local = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        total = all_reduce_(local.clone(), ctx.group)
        dx = (weight * invstd).view(shape) * (
            dyf - (total[0] / n).view(shape)
            - xhat * (total[1] / n).view(shape))
        return dx.to(x.dtype), local[1], local[0], None, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode statistics are summed over `group`."""

    def __init__(self, num_features: int, group=None, **kwargs):
        super().__init__(num_features, **kwargs)
        self.group = group

    def forward(self, x):
        if not self.training or self.group is None:
            return super().forward(x)
        y, mean, var, n = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                               self.eps, self.group)
        with torch.no_grad():
            self.num_batches_tracked += 1
            mom = self.momentum
            self.running_mean.mul_(1.0 - mom).add_(mom * mean)
            self.running_var.mul_(1.0 - mom).add_(mom * var * n / (n - 1))
        return y


def convert_sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Swap every BatchNorm2d of `module` for a SyncBatchNorm2d over
    `group`, keeping its parameters and buffers; a group of None (one rank
    on data) leaves the module as it is. Returns the module."""
    if group is None:
        return module
    for name, child in module.named_children():
        if type(child) is nn.BatchNorm2d:
            sync = SyncBatchNorm2d(child.num_features, group, eps=child.eps,
                                   momentum=child.momentum)
            sync.load_state_dict(child.state_dict())
            sync.to(child.weight.device, child.weight.dtype)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child, group)
    return module
