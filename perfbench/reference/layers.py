"""Layers shared by the reference models: parameter holders that carry the
port's state-dict names, and the plain forward of each."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def empty(*shape):
    return nn.Parameter(torch.empty(*shape))


class Conv(nn.Module):
    """`weight` (Cout, Cin, k, k) and, with `bias`, `bias` (Cout,)."""

    def __init__(self, cin, cout, k, bias=False):
        super().__init__()
        self.weight = empty(cout, cin, k, k)
        if bias:
            self.bias = empty(cout)
        else:
            self.bias = None


class ConvT(nn.Module):
    """`weight` (Cin, Cout, 2, 2) and `bias`: a transposed conv, stride 2."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = empty(cin, cout, 2, 2)
        self.bias = empty(cout)


class BN(nn.Module):
    """BatchNorm's parameters and running statistics (eps 1e-5)."""

    def __init__(self, c):
        super().__init__()
        self.weight = empty(c)
        self.bias = empty(c)
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, train: bool):
        """NCHW; batch statistics (biased variance) in train mode, the
        running ones in eval mode."""
        if train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class Affine(nn.Module):
    """`weight` and `bias` of a GroupNorm or LayerNorm."""

    def __init__(self, c):
        super().__init__()
        self.weight = empty(c)
        self.bias = empty(c)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = empty(cout, cin)
        self.bias = empty(cout)


def dropout(x, p: float, generator):
    """Inverted dropout with a mask from `generator`: keep where a uniform
    draw of x's shape is at least p."""
    if p == 0.0 or generator is None:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u >= p, x * (1.0 / (1.0 - p)), 0.0)


def relu(x):
    return F.relu(x)
