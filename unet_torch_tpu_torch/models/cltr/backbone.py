"""CLTR backbone: ResNet-50 with frozen BatchNorm (counterpart of
unet_torch_tpu/models/cltr/backbone.py).

`ResNet50` takes NHWC images and returns the NHWC layer4 map (1/32, 2048
channels), or layer1..layer4 with `return_interm`. Inside it runs NCHW
tensors in channels_last memory through cuDNN convs, as the JAX model's
convs run XLA's. Frozen BN is an affine map with constant statistics; its
four tensors are buffers (no gradient, not in the optimizer), as the JAX
model keeps them in `batch_stats`. Modules carry torchvision's `resnet50`
state_dict names (`conv1`, `bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`
and `.1`, ...), so a torchvision checkpoint loads natively
(`load_pretrained_resnet50`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine tensors, eps 1e-5. The
    per-channel scale and shift are computed in f32 and cast to the
    activations' dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype).view(1, -1, 1, 1)
                + shift.to(x.dtype).view(1, -1, 1, 1))


class Conv2d(nn.Conv2d):
    """Bias-free conv whose f32 weight is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = Conv2d(features, features * 4, 1)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(cin, features * 4, 1, stride=stride),
                FrozenBatchNorm(features * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """torchvision-layout ResNet-50 trunk; `layers` are the unit counts."""

    def __init__(self, layers=(3, 4, 6, 3), return_interm: bool = False,
                 generator=None):
        super().__init__()
        self.return_interm = return_interm
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (width, n) in enumerate(zip((64, 128, 256, 512), layers),
                                        start=1):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(
                    cin, width, stride=2 if (b == 0 and li > 1) else 1,
                    downsample=(b == 0)))
                cin = width * 4
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        # torchvision's initialisation
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        # torch pads the pool's border with -inf: padding never wins
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        interm = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            interm.append(x.permute(0, 2, 3, 1))
        return tuple(interm) if self.return_interm else interm[-1]


def backbone_freeze_mask(backbone: nn.Module) -> dict:
    """{parameter name: trainable} for the backbone's parameters: False for
    the stem and layer1 (the reference's BackboneBase freezing), True
    elsewhere. As in the JAX package, nothing applies it: the train step
    updates every backbone parameter."""
    return {name: not (name.startswith("conv1.")
                       or name.startswith("layer1."))
            for name, _ in backbone.named_parameters()}
