"""Pre-activation ResNetV2 hybrid backbone (counterpart of
unet_torch_tpu/models/transunet/resnetv2.py, which mirrors the reference's
vit_seg_modeling_resnet_skip.py).

Weight-standardised convs (StdConv2d: per output channel over (I, H, W),
biased variance, eps 1e-5), GroupNorm(32, eps 1e-6) bottlenecks (3, 4, 9
units), a 7x7/s2 root and a 3x3/s2 VALID max pool that floors (256 -> 127 at
a 512x512 input). The skip features are zero-padded at the bottom and right
to in_size/4/(i+1) (127 -> 128 at 512x512). The JAX package's space-to-depth
root is a TPU rewrite of the same conv and is not carried over.

Modules carry the reference's state_dict names (root.conv, root.gn,
body.block{b}.unit{u}.{conv1,gn1,...,downsample,gn_proj}). Activations are
NCHW in channels_last memory; parameters stay f32 and each layer computes in
its input's dtype.

On a strip of a spatial mesh (parallel/spatial.py; M strips of S rows,
S a multiple of 16) the convs read their neighbours' rows and the
GroupNorms sum their statistics over the strips (nn/strips.py). The
height halves four times: the root conv (S/2 rows a strip), the pool, and
the first units of blocks 2 and 3 (S/8, S/16). The pool is VALID and
floors (the whole image's root map of R rows pools to R/2 - 1), so its
strips are uneven. Ownership rule: a pooled row j belongs to the strip
that holds root row 2j, the top of its window; every strip owns S/4 pooled
rows but the last, which owns S/4 - 1, and each reads the first root row
of the strip below it (exchange_rows with 0 rows above, 1 below; the last
strip, whose window would pass the image's end, reads none). Every later
strided conv starts its strips at even rows, so from block 2 on the
strips are even again. The skip of block 1 is padded at the bottom and
the right to S/4 rows a strip: the padded zero row belongs to the last
strip, and no GroupNorm sees it (the skips only feed the decoder).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.core.dist import exchange_rows
from unet_torch_tpu_torch.nn.dropout import MeshBound
from unet_torch_tpu_torch.nn.strips import strip_conv2d, strip_group_norm


class StdConv2d(MeshBound, nn.Conv2d):
    """Conv2d with its weight standardised on every call."""

    def forward(self, x):
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True,
                                   unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        return strip_conv2d(x, w.to(x.dtype), None, self.stride,
                            self.padding, self.strip_group)


class GroupNorm(MeshBound, nn.GroupNorm):
    """GroupNorm in the input's dtype (statistics in f32 inside torch)."""

    def forward(self, x):
        group = self.strip_group
        if group is None:
            return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps)
        return strip_group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps, group)


def _conv1x1(cin, cout, stride=1):
    return StdConv2d(cin, cout, 1, stride=stride, bias=False)


class PreActBottleneck(nn.Module):
    """1x1 -> GN -> ReLU -> 3x3 (stride) -> GN -> ReLU -> 1x1 -> GN, plus the
    residual (a strided 1x1 StdConv and GroupNorm(cout, cout, eps 1e-5) where
    the shape changes), then ReLU."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = _conv1x1(cin, cmid)
        self.gn2 = GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1,
                               bias=False)
        self.gn3 = GroupNorm(32, cout, eps=1e-6)
        self.conv3 = _conv1x1(cmid, cout)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or cin != cout:
            self.downsample = _conv1x1(cin, cout, stride)
            self.gn_proj = GroupNorm(cout, cout)

    def forward(self, x):
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
        y = self.relu(self.gn1(self.conv1(x)))
        y = self.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return self.relu(residual + y)


class ResNetV2(MeshBound, nn.Module):
    """NCHW in -> (bottleneck features, [skip 1/8, skip 1/4, root 1/2])."""

    def __init__(self, block_units=(3, 4, 9), width_factor: int = 1):
        super().__init__()
        width = int(64 * width_factor)
        self.width = width
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(3, width, 7, stride=2, padding=3, bias=False)),
            ("gn", GroupNorm(32, width, eps=1e-6)),
            ("relu", nn.ReLU(inplace=True)),
        ]))
        stages = [(width * 4, width, 1), (width * 8, width * 2, 2),
                  (width * 16, width * 4, 2)]
        blocks = []
        cin = width
        for i, ((cout, cmid, stride), n_units) in enumerate(
                zip(stages, block_units)):
            units = [(f"unit{u}", PreActBottleneck(
                cin if u == 1 else cout, cout, cmid, stride if u == 1 else 1))
                for u in range(1, n_units + 1)]
            blocks.append((f"block{i + 1}", nn.Sequential(OrderedDict(units))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(blocks))

    def forward(self, x):
        group, strips = self.strip_group, 1
        if group is not None:
            strips = self.mesh.model
        in_size = x.shape[2] * strips
        x = self.root(x)
        features = [x]
        if group is not None:
            # a pooled row's window reads the first root row of the strip
            # below; the last strip's would pass the image's end
            x = exchange_rows(x, group, above=0, below=1)
            if self.mesh.m == strips - 1:
                x = x[:, :, :-1]
        x = F.max_pool2d(x, 3, stride=2)
        for i, block in enumerate(self.body):
            x = block(x)
            if i < len(self.body) - 1:
                size = int(in_size / 4 / (i + 1))
                pad_w = size - x.shape[3]
                pad_h = size // strips - x.shape[2]
                features.append(F.pad(x, (0, pad_w, 0, pad_h))
                                if pad_w or pad_h else x)
        return x, features[::-1]
