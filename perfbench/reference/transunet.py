"""The plain TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306; the
reference's `get_r50_b16_config`) as the port's `TransUnet` model type
builds it, float32.

- ResNetV2 hybrid: weight-standardised convs (biased variance, eps 1e-5),
  a 7x7/2 root with GroupNorm(32, eps 1e-6) and ReLU, a 3x3/2 VALID max
  pool, bottleneck stages of (3, 4, 9) units (1x1, 3x3 with the stride,
  1x1, each followed by GroupNorm(32, eps 1e-6); a strided 1x1 and
  GroupNorm(cout, cout, eps 1e-5) on the residual where the shape
  changes). The skips are zero-padded at the bottom and right to
  in_size / 4 / (i + 1).
- Patch embedding: a 1x1 conv to the hidden width, learned position
  embeddings, dropout.
- Encoder: pre-LN blocks (LayerNorm eps 1e-6): softmax attention of 12
  heads of 64 with its out projection, an MLP of exact GELU, dropout after
  the GELU and after the MLP; a final LayerNorm.
- CUP decoder: the tokens as a 32 x 32 map, conv3x3 + BN + ReLU to 512,
  then four blocks of 2x bilinear upsampling (align corners), the skip
  concatenated, two conv3x3 + BN + ReLU; a conv3x3 head with bias.

Dropout draws `torch.rand` of each activation's shape from the generator
given, in the order of the forward, as the port's dropouts draw from the
train step's generator. Parameters carry the port's state-dict names."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import (
    BN,
    Affine,
    Conv,
    Dense,
    dropout,
    empty,
    relu,
)
from perfbench.reference.ops import Ops


def std_conv(ops: Ops, conv: Conv, x, stride=1, padding=0):
    w = conv.weight
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                               unbiased=False)
    return ops.conv2d(x, (w - mean) / torch.sqrt(var + 1e-5), None, stride,
                      padding)


def group_norm(x, groups, norm: Affine, eps):
    return F.group_norm(x, groups, norm.weight, norm.bias, eps)


class Unit(nn.Module):
    def __init__(self, cin, cout, cmid, stride):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(cin, cmid, 1)
        self.gn1 = Affine(cmid)
        self.conv2 = Conv(cmid, cmid, 3)
        self.gn2 = Affine(cmid)
        self.conv3 = Conv(cmid, cout, 1)
        self.gn3 = Affine(cout)
        if stride != 1 or cin != cout:
            self.downsample = Conv(cin, cout, 1)
            self.gn_proj = Affine(cout)

    def forward(self, x, ops):
        residual = x
        if hasattr(self, "downsample"):
            residual = group_norm(
                std_conv(ops, self.downsample, x, self.stride),
                self.gn_proj.weight.shape[0], self.gn_proj, 1e-5)
        y = relu(group_norm(std_conv(ops, self.conv1, x), 32, self.gn1,
                            1e-6))
        y = relu(group_norm(std_conv(ops, self.conv2, y, self.stride, 1), 32,
                            self.gn2, 1e-6))
        y = group_norm(std_conv(ops, self.conv3, y), 32, self.gn3, 1e-6)
        return relu(residual + y)


class ResNetV2(nn.Module):
    def __init__(self, block_units=(3, 4, 9), width=64):
        super().__init__()
        self.root = nn.ModuleDict({"conv": Conv(3, width, 7),
                                   "gn": Affine(width)})
        stages = [(width * 4, width, 1), (width * 8, width * 2, 2),
                  (width * 16, width * 4, 2)]
        blocks, cin = {}, width
        for i, ((cout, cmid, stride), n) in enumerate(zip(stages,
                                                          block_units)):
            blocks[f"block{i + 1}"] = nn.ModuleDict({
                f"unit{u}": Unit(cin if u == 1 else cout, cout, cmid,
                                 stride if u == 1 else 1)
                for u in range(1, n + 1)})
            cin = cout
        self.body = nn.ModuleDict(blocks)

    def forward(self, x, ops):
        in_size = x.shape[2]
        x = relu(group_norm(std_conv(ops, self.root["conv"], x, 2, 3), 32,
                            self.root["gn"], 1e-6))
        features = [x]
        x = F.max_pool2d(x, 3, stride=2)
        for i, block in enumerate(self.body.values()):
            for unit in block.values():
                x = unit(x, ops)
            if i < len(self.body) - 1:
                size = int(in_size / 4 / (i + 1))
                features.append(F.pad(x, (0, size - x.shape[3], 0,
                                          size - x.shape[2])))
        return x, features[::-1]


class Attention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.query = Dense(hidden, hidden)
        self.key = Dense(hidden, hidden)
        self.value = Dense(hidden, hidden)
        self.out = Dense(hidden, hidden)

    def forward(self, x, ops):
        b, n, c = x.shape
        h, d = self.heads, c // self.heads

        def split(layer):
            return ops.linear(x, layer.weight, layer.bias).view(
                b, n, h, d).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        ops.record("attention", (b, h, n, n, d, d))
        p = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(d),
                          dim=-1)
        ctx = ops.matmul(p, v).transpose(1, 2).reshape(b, n, c)
        return ops.linear(ctx, self.out.weight, self.out.bias)


class Mlp(nn.Module):
    def __init__(self, hidden, mlp_dim):
        super().__init__()
        self.fc1 = Dense(hidden, mlp_dim)
        self.fc2 = Dense(mlp_dim, hidden)


class Block(nn.Module):
    def __init__(self, hidden, heads, mlp_dim):
        super().__init__()
        self.attention_norm = Affine(hidden)
        self.ffn_norm = Affine(hidden)
        self.ffn = Mlp(hidden, mlp_dim)
        self.attn = Attention(hidden, heads)

    def forward(self, x, ops, p, generator):
        c = x.shape[-1]
        a = self.attention_norm
        x = x + self.attn(F.layer_norm(x, (c,), a.weight, a.bias, 1e-6), ops)
        f = self.ffn_norm
        y = F.layer_norm(x, (c,), f.weight, f.bias, 1e-6)
        y = dropout(F.gelu(ops.linear(y, self.ffn.fc1.weight,
                                      self.ffn.fc1.bias)), p, generator)
        y = dropout(ops.linear(y, self.ffn.fc2.weight, self.ffn.fc2.bias), p,
                    generator)
        return x + y


class ConvBNReLU(nn.ModuleDict):
    """`0` conv3x3 without bias, `1` BatchNorm: the port's Conv2dReLU."""

    def __init__(self, cin, cout):
        super().__init__({"0": Conv(cin, cout, 3), "1": BN(cout)})

    def forward(self, x, ops, train):
        conv = self["0"]
        ops.record("conv_bn_relu", (x.shape[2], x.shape[1],
                                    conv.weight.shape[0]))
        return relu(self["1"](ops.conv2d(x, conv.weight, padding=1), train))


class TransUnet(nn.Module):
    def __init__(self, img_size=512, num_classes=3, hidden=768, heads=12,
                 mlp_dim=3072, layers=12, block_units=(3, 4, 9),
                 decoder_channels=(256, 128, 64, 16),
                 skip_channels=(512, 256, 64, 16), n_skip=3,
                 dropout_rate=0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        grid = img_size // 16
        self.transformer = nn.Module()
        emb = nn.Module()
        emb.hybrid_model = ResNetV2(block_units)
        emb.patch_embeddings = Conv(1024, hidden, 1, bias=True)
        emb.position_embeddings = empty(1, grid * grid, hidden)
        self.transformer.embeddings = emb
        enc = nn.Module()
        enc.layer = nn.ModuleList(Block(hidden, heads, mlp_dim)
                                  for _ in range(layers))
        enc.encoder_norm = Affine(hidden)
        self.transformer.encoder = enc
        self.decoder = nn.Module()
        self.decoder.conv_more = ConvBNReLU(hidden, 512)
        ins = [512] + list(decoder_channels[:-1])
        skips = [skip_channels[i] if i < n_skip else 0
                 for i in range(len(decoder_channels))]
        self.decoder.blocks = nn.ModuleList(
            nn.ModuleDict({"conv1": ConvBNReLU(i + s, o),
                           "conv2": ConvBNReLU(o, o)})
            for i, o, s in zip(ins, decoder_channels, skips))
        self.n_skip = n_skip
        self.segmentation_head = nn.ModuleDict(
            {"0": Conv(decoder_channels[-1], num_classes, 3, bias=True)})

    def forward(self, x, ops: Ops, train: bool = False, generator=None):
        """x (B, H, W, 3) -> logits (B, H, W, classes). Dropout only with
        `train` and a generator."""
        p = self.dropout_rate if train else 0.0
        emb = self.transformer.embeddings
        x, features = emb.hybrid_model(x.permute(0, 3, 1, 2), ops)
        pe = emb.patch_embeddings
        x = ops.conv2d(x, pe.weight, pe.bias)
        b, c, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2) + emb.position_embeddings
        x = dropout(x, p, generator)
        enc = self.transformer.encoder
        for block in enc.layer:
            x = block(x, ops, p, generator)
        x = F.layer_norm(x, (c,), enc.encoder_norm.weight,
                         enc.encoder_norm.bias, 1e-6)
        x = x.transpose(1, 2).reshape(b, c, gh, gw)
        x = self.decoder.conv_more(x, ops, train)
        for i, block in enumerate(self.decoder.blocks):
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=True)
            if i < self.n_skip:
                x = torch.cat([x, features[i]], dim=1)
            x = block["conv2"](block["conv1"](x, ops, train), ops, train)
        head = self.segmentation_head["0"]
        return ops.conv2d(x, head.weight, head.bias, 1, 1).permute(0, 2, 3, 1)


def build(spec: dict) -> TransUnet:
    m = spec["model"]
    return TransUnet(
        img_size=m["img_size"], num_classes=m["num_classes"],
        hidden=m["hidden_size"], heads=m["num_heads"], mlp_dim=m["mlp_dim"],
        layers=m["num_layers"], block_units=tuple(m["resnet_units"]),
        decoder_channels=tuple(m["decoder_channels"]),
        skip_channels=tuple(m["skip_channels"]), n_skip=m["n_skip"],
        dropout_rate=m["dropout_rate"])
