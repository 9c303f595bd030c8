"""U-Net building blocks (counterpart of unet_torch_tpu/nn/blocks.py).

The modules carry the reference's state_dict names, so that a reference
`best.pt` loads with a strict key check:

  DoubleConv  double_conv.{0,3} Conv2d 3x3 no bias, {1,4} BatchNorm2d, {2,5} ReLU
  Down        maxpool_conv.0 MaxPool2d(2), maxpool_conv.1 DoubleConv
  Up          up ConvTranspose2d(C, C/2, 2, stride 2), conv DoubleConv
  OutConv     conv Conv2d 1x1 with bias
  AttentionGate  up ConvTranspose2d(Cq, Cq, 2, stride 2); W_q, W_x, psi each
              {0} Conv2d 1x1 with bias, {1} BatchNorm2d

Activations are NCHW tensors in channels_last memory. Parameters stay f32;
each layer computes in the dtype of its input and casts its weights to it.

In eval mode each conv+BN+ReLU pair of DoubleConv folds its BN running
statistics into a scale and bias and runs as one fused_conv3x3_bn_relu call
(the Hopper kernel on a CUDA tensor). In train mode the pair runs torch's
conv (weight cast to the input's dtype), BN (batch statistics in f32, the
running ones kept f32 with torch's unbiased variance update, as the
reference's BatchNorm2d keeps them) and ReLU. Dropout draws from the
generator bound by nn/dropout.py::set_dropout_generator.

Under a spatial mesh (parallel/spatial.py::spatialize) a rank holds a strip
of the image's height, and DoubleConv, the family's only 3x3 convs, reads
one row of each neighbouring strip (core/dist.py::exchange_rows) before
each conv: in train mode torch's conv then pads the width alone; in eval
mode the fused conv runs on the haloed strip and keeps its inner rows,
which are the strip's rows of the whole image's conv.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.core.dist import exchange_rows
from unet_torch_tpu_torch.kernels.fused_conv import (
    fold_bn,
    fused_conv3x3_bn_relu,
)
from unet_torch_tpu_torch.nn.dropout import Dropout, MeshBound


def reset_parameters(module: nn.Module, generator=None) -> None:
    """The reference's initialisation, drawn from `generator`.

    Conv2d weights: kaiming_normal (fan_in, gain sqrt 2), the reference's
    weights_init. Every bias and the ConvTranspose2d weights keep torch's
    defaults, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with torch's fan_in. BN:
    weight 1, bias 0, running mean 0, running var 1 (the JAX package's
    kaiming_normal, torch_uniform_init and torch_convt_kernel_init)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.ConvTranspose2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class DoubleConv(MeshBound, nn.Module):
    """(Conv3x3 pad=1 bias=False -> BatchNorm -> ReLU) * 2; on a strip of a
    spatial mesh, with the neighbours' rows (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1, bias=False),
            nn.BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            nn.Conv2d(mid, out_channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        group = self.strip_group
        pairs = ((self.double_conv[0], self.double_conv[1]),
                 (self.double_conv[3], self.double_conv[4]))
        if self.training:
            for conv, bn in pairs:
                w = conv.weight.to(x.dtype)
                y = (F.conv2d(x, w, padding=1) if group is None else
                     F.conv2d(exchange_rows(x, group), w, padding=(0, 1)))
                x = F.relu(bn(y))
            return x
        h = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for conv, bn in pairs:
            scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps)
            w = conv.weight.permute(2, 3, 1, 0).to(h.dtype).contiguous()
            if group is None:
                h = fused_conv3x3_bn_relu(h, w, scale, bias)
            else:
                h = fused_conv3x3_bn_relu(exchange_rows(h, group, dim=1), w,
                                          scale, bias)[:, 1:-1]
        return h.permute(0, 3, 1, 2)


class Down(nn.Module):
    """2x2 max pool (floors odd sizes), optional dropout, DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout: bool = False, dropout_p: float = 0.5):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))
        self.dropout = Dropout(dropout_p if dropout else 0.0)

    def forward(self, x):
        x = self.maxpool_conv[0](x)
        return self.maxpool_conv[1](self.dropout(x))


class Up(nn.Module):
    """ConvTranspose k=2 s=2 halving channels, pad to the skip's size (split
    [d//2, d-d//2]), concat [skip, up], optional dropout, DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout: bool = False, dropout_p: float = 0.5):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, 2,
                                     stride=2)
        self.conv = DoubleConv(in_channels, out_channels)
        self.dropout = Dropout(dropout_p if dropout else 0.0)

    def forward(self, x1, x2):
        x1 = F.conv_transpose2d(x1, self.up.weight.to(x1.dtype),
                                self.up.bias.to(x1.dtype), stride=2)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(self.dropout(torch.cat([x2, x1], dim=1)))


class OutConv(nn.Module):
    """1x1 conv head to n_classes."""

    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, n_classes, 1)

    def forward(self, x):
        return F.conv2d(x, self.conv.weight.to(x.dtype),
                        self.conv.bias.to(x.dtype))


class AttentionGate(nn.Module):
    """Additive attention gate on a skip connection.

    q: the coarse gating feature (Cq, H, W); x: the skip feature
    (Cx, 2H, 2W). up(q) -> W_q and W_x (1x1 conv + BN each) ->
    ReLU(q1 + x1) -> psi (1x1 conv + BN) -> sigmoid -> x * a."""

    def __init__(self, q_channels: int, x_channels: int, hidden: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(q_channels, q_channels, 2, stride=2)
        self.W_q = nn.Sequential(nn.Conv2d(q_channels, hidden, 1),
                                 nn.BatchNorm2d(hidden))
        self.W_x = nn.Sequential(nn.Conv2d(x_channels, hidden, 1),
                                 nn.BatchNorm2d(hidden))
        self.psi = nn.Sequential(nn.Conv2d(hidden, 1, 1), nn.BatchNorm2d(1))

    @staticmethod
    def _proj(seq, v):
        conv, bn = seq[0], seq[1]
        return bn(F.conv2d(v, conv.weight.to(v.dtype),
                           conv.bias.to(v.dtype)))

    def forward(self, q, x):
        q = F.conv_transpose2d(q, self.up.weight.to(q.dtype),
                               self.up.bias.to(q.dtype), stride=2)
        e = F.relu(self._proj(self.W_q, q) + self._proj(self.W_x, x))
        return x * torch.sigmoid(self._proj(self.psi, e))
