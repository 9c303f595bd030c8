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

On a strip of a spatial mesh (parallel/spatial.py) the convs read their
neighbours' rows (nn/strips.py::strip_conv2d: 3 above and 3 below the 7x7/2
conv1, 1 and 1 the 3x3s) and the padded 3/2 max pool one row each way; the
image's own border rows are zeros there, which the pool reads as torch's
-inf padding would, since its input is a ReLU's. Frozen BN is local. Each
strided layer starts its strips at even rows: a strip's height is a
multiple of 32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.core.dist import exchange_rows
from unet_torch_tpu_torch.nn.dropout import MeshBound
from unet_torch_tpu_torch.nn.strips import strip_conv2d


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


class Conv2d(MeshBound, nn.Conv2d):
    """Bias-free conv whose f32 weight is cast to the input's dtype."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x):
        return strip_conv2d(x, self.weight.to(x.dtype), None, self.stride,
                            self.padding, self.strip_group)


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


class ResNet50(MeshBound, nn.Module):
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
        group = self.strip_group
        if group is None:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        else:
            x = F.max_pool2d(exchange_rows(x, group), 3, stride=2,
                             padding=(0, 1))
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
