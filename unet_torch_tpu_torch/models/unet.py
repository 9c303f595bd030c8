"""U-Net (counterpart of unet_torch_tpu/models/unet.py).

`UNet` takes NHWC input (B,H,W,C_in) and returns NHWC logits
(B,H,W,n_classes), as the JAX model does, computed in the input's dtype.
Inside, the NHWC input is viewed as NCHW in channels_last memory (a permute,
no copy).

Channel codes (reference Model.py:99-104): -1 -> 1 input channel (HED
hematoxylin), -2 -> 3 channels (Macenko-normalised RGB).
"""

from __future__ import annotations

import warnings

from torch import nn

from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.nn.blocks import (
    DoubleConv,
    Down,
    OutConv,
    Up,
    reset_parameters,
)

# options of the JAX package that shape TPU layouts or memory; no meaning here
_TPU_OPTIONS = ("fold", "remat", "head_dtype")

# built by models/transunet/vit.py::build_transunet, as in the JAX package
_TRANSUNET_TYPES = ("TransUnet", "regression_t", "multi_task_regTU")


def resolve_channels(n_channels: int) -> int:
    if n_channels == -2:
        return 3
    if n_channels == -1:
        return 1
    return n_channels


class UNet(nn.Module):
    """Vanilla U-Net. Input (B,H,W,C_in) -> logits (B,H,W,n_classes)."""

    def __init__(self, n_channels: int, n_classes: int, base: int = 64,
                 dropout: bool = False, dropout_p: float = 0.5,
                 generator=None):
        super().__init__()
        self.inc = DoubleConv(n_channels, base)
        self.down1 = Down(base, base * 2, dropout, dropout_p)
        self.down2 = Down(base * 2, base * 4, dropout, dropout_p)
        self.down3 = Down(base * 4, base * 8, dropout, dropout_p)
        self.down4 = Down(base * 8, base * 16, dropout, dropout_p)
        self.up1 = Up(base * 16, base * 8, dropout, dropout_p)
        self.up2 = Up(base * 8, base * 4, dropout, dropout_p)
        self.up3 = Up(base * 4, base * 2, dropout, dropout_p)
        self.up4 = Up(base * 2, base, dropout, dropout_p)
        self.outc = OutConv(base, n_classes)
        reset_parameters(self, generator)

    def forward(self, x):
        x1 = self.inc(x.permute(0, 3, 1, 2))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x).permute(0, 2, 3, 1)


def ignore_tpu_options(tpu_options: dict) -> None:
    """Warn about each TPU option (`fold`, `remat`, `head_dtype`) of the JAX
    package, which the port accepts for config compatibility and ignores;
    raise on any other keyword."""
    for key in tpu_options:
        if key not in _TPU_OPTIONS:
            raise TypeError(f"unexpected model option {key!r}")
        warnings.warn(f"{key}={tpu_options[key]!r} is a TPU option of the JAX "
                      "package; the port ignores it", stacklevel=3)


def build_model(model_type: str, *, n_channels: int, n_classes: int,
                base: int = 64, dropout: bool = False, dropout_p: float = 0.5,
                generator=None, **tpu_options):
    """Model factory for the ported part of the UNet family
    (`TransUnet_unet_fallback` is the plain UNet, as in the JAX package).

    `fold`, `remat` and `head_dtype` are accepted for config compatibility
    with the JAX package and ignored with a warning."""
    ignore_tpu_options(tpu_options)
    if model_type in ("single", "regression", "TransUnet_unet_fallback"):
        return UNet(resolve_channels(n_channels), n_classes, base, dropout,
                    dropout_p, generator=generator)
    if model_type in _TRANSUNET_TYPES:
        raise ValueError(f"model_type {model_type!r} is built by "
                         "models.transunet.build_transunet")
    not_ported.check(not_ported.MODEL_TYPES, "model_type", model_type)
    raise ValueError(f"Invalid model_type {model_type!r}")
