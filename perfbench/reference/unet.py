"""The plain U-Net of Ronneberger et al. (arXiv:1505.04597) as the port's
`single` model type builds it: four levels down and four up, each level
two conv3x3 (no bias) + BatchNorm + ReLU, 2x2 max pools, transposed convs
of stride 2 that halve the channels, the skip concatenated before the up
path's features, and a 1x1 head. NHWC in, NHWC logits out, float32.

Parameters carry the port's state-dict names, so one weight dict loads
into both. `flops` counts a forward (and backward) at a shape on the meta
device; the conv3x3 + BN + ReLU calls are recorded as ("conv_bn_relu",
(h, cin, cout)) for the fused conv's bound."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import BN, Conv, ConvT, relu
from perfbench.reference.ops import Ops


class DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.double_conv = nn.ModuleDict({
            "0": Conv(cin, cout, 3), "1": BN(cout),
            "3": Conv(cout, cout, 3), "4": BN(cout)})

    def forward(self, x, ops: Ops, train: bool):
        for c, b in (("0", "1"), ("3", "4")):
            conv, bn = self.double_conv[c], self.double_conv[b]
            ops.record("conv_bn_relu", (x.shape[2], x.shape[1],
                                        conv.weight.shape[0]))
            x = relu(bn(ops.conv2d(x, conv.weight, padding=1), train))
        return x


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.ModuleDict({"1": DoubleConv(cin, cout)})

    def forward(self, x, ops, train):
        return self.maxpool_conv["1"](F.max_pool2d(x, 2), ops, train)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = ConvT(cin, cin // 2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2, ops, train):
        x1 = ops.conv_transpose2d(x1, self.up.weight, self.up.bias, 2)
        return self.conv(torch.cat([x2, x1], dim=1), ops, train)


class OutConv(nn.Module):
    def __init__(self, cin, n_classes):
        super().__init__()
        self.conv = Conv(cin, n_classes, 1, bias=True)


class UNet(nn.Module):
    def __init__(self, n_channels: int, n_classes: int, base: int = 64):
        super().__init__()
        self.inc = DoubleConv(n_channels, base)
        self.down1 = Down(base, base * 2)
        self.down2 = Down(base * 2, base * 4)
        self.down3 = Down(base * 4, base * 8)
        self.down4 = Down(base * 8, base * 16)
        self.up1 = Up(base * 16, base * 8)
        self.up2 = Up(base * 8, base * 4)
        self.up3 = Up(base * 4, base * 2)
        self.up4 = Up(base * 2, base)
        self.outc = OutConv(base, n_classes)

    def forward(self, x, ops: Ops, train: bool = False, generator=None):
        """x (B, H, W, C) -> logits (B, H, W, n_classes). The model has no
        dropout: `generator` is not drawn from."""
        x1 = self.inc(x.permute(0, 3, 1, 2), ops, train)
        x2 = self.down1(x1, ops, train)
        x3 = self.down2(x2, ops, train)
        x4 = self.down3(x3, ops, train)
        x5 = self.down4(x4, ops, train)
        x = self.up1(x5, x4, ops, train)
        x = self.up2(x, x3, ops, train)
        x = self.up3(x, x2, ops, train)
        x = self.up4(x, x1, ops, train)
        head = self.outc.conv
        return ops.conv2d(x, head.weight, head.bias).permute(0, 2, 3, 1)


def build(spec: dict) -> UNet:
    """The model of a configuration file's `model` section."""
    m = spec["model"]
    return UNet(m["in_channels"], m["num_classes"], m["base"])
