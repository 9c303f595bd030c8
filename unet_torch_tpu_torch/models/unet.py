"""The U-Net family (counterpart of unet_torch_tpu/models/unet.py).

  UNet           4-down / 4-up encoder-decoder
  UNetMultitask  shared encoder, two independent decoders and heads; returns
                 (logits1, logits2)
  UNetAttention  UNet with an attention gate on each skip before its Up block

Each model takes NHWC input (B,H,W,C_in) and returns NHWC logits
(B,H,W,n_classes), as the JAX model does, computed in the input's dtype.
Inside, the NHWC input is viewed as NCHW in channels_last memory (a permute,
no copy).

Channel codes (reference Model.py:99-104): -1 -> 1 input channel (HED
hematoxylin), -2 -> 3 channels (Macenko-normalised RGB).

`UNet(remat=True)` (the `single` and `regression` types, as in the JAX CLI)
recomputes its first DoubleConv, its Down blocks and its Up blocks in the
backward instead of keeping their activations (the JAX `nn.remat` of the
same blocks), through `torch.utils.checkpoint`. The recompute replays the
dropout generator's state of the forward, so it draws the same masks, and
keeps the BatchNorms' running statistics as the forward left them, so they
are updated once a step.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unet_torch_tpu_torch.core import not_ported
from unet_torch_tpu_torch.nn.blocks import (
    AttentionGate,
    DoubleConv,
    Down,
    OutConv,
    Up,
    reset_parameters,
)

# options of the JAX package that shape TPU layouts; no meaning here (`remat`
# has one for the plain UNet, which takes it itself)
_TPU_OPTIONS = ("fold", "remat", "head_dtype")

# the TransUnet types the CLIs train and serve, built by
# models/transunet/vit.py::build_transunet (which builds multitask_em too),
# as in the JAX package
TRANSUNET_TYPES = ("TransUnet", "regression_t", "multi_task_regTU")


def resolve_channels(n_channels: int) -> int:
    if n_channels == -2:
        return 3
    if n_channels == -1:
        return 1
    return n_channels


@contextlib.contextmanager
def _replay(block: nn.Module, generator, state):
    """The recompute of `block`: its dropout generator at `state` (the
    forward's), then back where it was; its buffers (BN running statistics,
    batch counts) kept as the forward left them."""
    now = None if generator is None else generator.get_state()
    buffers = [(b, b.clone()) for b in block.buffers()]
    if generator is not None:
        generator.set_state(state)
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(now)
        with torch.no_grad():
            for b, value in buffers:
                b.copy_(value)


def recompute(block: nn.Module, *args):
    """block(*args), its activations recomputed in the backward where
    autograd records a train-mode forward (module docstring)."""
    if not (block.training and torch.is_grad_enabled()):
        return block(*args)
    generator = next((m.generator for m in block.modules()
                      if getattr(m, "generator", None) is not None), None)
    state = None if generator is None else generator.get_state()
    return checkpoint(block, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _replay(block, generator, state)))


class UNet(nn.Module):
    """Vanilla U-Net. Input (B,H,W,C_in) -> logits (B,H,W,n_classes).
    `remat`: recompute the blocks' activations in the backward (module
    docstring)."""

    def __init__(self, n_channels: int, n_classes: int, base: int = 64,
                 dropout: bool = False, dropout_p: float = 0.5,
                 generator=None, remat: bool = False):
        super().__init__()
        self.remat = remat
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
        run = recompute if self.remat else (lambda block, *args: block(*args))
        x1 = run(self.inc, x.permute(0, 3, 1, 2))
        x2 = run(self.down1, x1)
        x3 = run(self.down2, x2)
        x4 = run(self.down3, x3)
        x5 = run(self.down4, x4)
        x = run(self.up1, x5, x4)
        x = run(self.up2, x, x3)
        x = run(self.up3, x, x2)
        x = run(self.up4, x, x1)
        return self.outc(x).permute(0, 2, 3, 1)


class UNetMultitask(nn.Module):
    """Shared encoder and two independent decoders; returns (logits1,
    logits2). The decoders carry the reference's names: `up{i}_decod1`,
    `outc_decod1`, `up{i}_decod2`, `outc_decod2`.

    As in the JAX package, this model has no dropout: `dropout` and
    `dropout_p` are accepted for the factory's signature and not used."""

    def __init__(self, n_channels: int, n_classes: int, base: int = 64,
                 dropout: bool = False, dropout_p: float = 0.5,
                 generator=None):
        super().__init__()
        self.inc = DoubleConv(n_channels, base)
        for i in range(1, 5):
            setattr(self, f"down{i}", Down(base << (i - 1), base << i))
        for head in ("_decod1", "_decod2"):
            for i in range(1, 5):
                setattr(self, f"up{i}{head}",
                        Up(base << (5 - i), base << (4 - i)))
            setattr(self, f"outc{head}", OutConv(base, n_classes))
        reset_parameters(self, generator)

    def add_log_vars(self) -> None:
        """Register `log_vars`, the two learned log-variances of the
        uncertainty-weighted loss (zeros), unless the model has them. They
        are a parameter of the model, so they ride its optimizer and its
        state_dict."""
        if not hasattr(self, "log_vars"):
            device = next(self.parameters()).device
            self.log_vars = nn.Parameter(torch.zeros(2, device=device))

    def _decode(self, feats, head):
        x1, x2, x3, x4, x = feats
        for i, skip in enumerate((x4, x3, x2, x1), start=1):
            x = getattr(self, f"up{i}{head}")(x, skip)
        return getattr(self, f"outc{head}")(x).permute(0, 2, 3, 1)

    def forward(self, x):
        feats = [self.inc(x.permute(0, 3, 1, 2))]
        for i in range(1, 5):
            feats.append(getattr(self, f"down{i}")(feats[-1]))
        return self._decode(feats, "_decod1"), self._decode(feats, "_decod2")


class UNetAttention(nn.Module):
    """U-Net with attention gates applied to each skip before the Up block.
    The gates carry the reference's names, `attenion1..4` (sic)."""

    def __init__(self, n_channels: int, n_classes: int, base: int = 64,
                 dropout: bool = False, dropout_p: float = 0.5,
                 generator=None):
        super().__init__()
        b = base
        self.inc = DoubleConv(n_channels, b)
        self.down1 = Down(b, b * 2, dropout, dropout_p)
        self.down2 = Down(b * 2, b * 4, dropout, dropout_p)
        self.down3 = Down(b * 4, b * 8, dropout, dropout_p)
        self.down4 = Down(b * 8, b * 16, dropout, dropout_p)
        # gate i: (channels of the gating feature, of the skip, hidden)
        self.attenion4 = AttentionGate(b * 16, b * 8, b * 4)
        self.attenion3 = AttentionGate(b * 8, b * 4, b * 2)
        self.attenion2 = AttentionGate(b * 4, b * 2, b)
        self.attenion1 = AttentionGate(b * 2, b, b // 2)
        self.up1 = Up(b * 16, b * 8, dropout, dropout_p)
        self.up2 = Up(b * 8, b * 4, dropout, dropout_p)
        self.up3 = Up(b * 4, b * 2, dropout, dropout_p)
        self.up4 = Up(b * 2, b, dropout, dropout_p)
        self.outc = OutConv(b, n_classes)
        reset_parameters(self, generator)

    def forward(self, x):
        x1 = self.inc(x.permute(0, 3, 1, 2))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, self.attenion4(x5, x4))
        x = self.up2(x, self.attenion3(x, x3))
        x = self.up3(x, self.attenion2(x, x2))
        x = self.up4(x, self.attenion1(x, x1))
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
    """Model factory for the UNet family (`TransUnet_unet_fallback` is the
    plain UNet, as in the JAX package).

    `remat` recomputes the plain UNet's blocks in the backward (`single`,
    `regression`, the types the JAX CLI passes it for); `fold`,
    `head_dtype` and `remat` for the other types are accepted for config
    compatibility with the JAX package and ignored with a warning."""
    if model_type in ("single", "regression", "TransUnet_unet_fallback"):
        remat = bool(tpu_options.pop("remat", False))
        ignore_tpu_options(tpu_options)
        return UNet(resolve_channels(n_channels), n_classes, base, dropout,
                    dropout_p, generator=generator, remat=remat)
    ignore_tpu_options(tpu_options)
    if model_type in ("multi_task", "multi_task_reg"):
        return UNetMultitask(resolve_channels(n_channels), n_classes, base,
                             dropout, dropout_p, generator=generator)
    if model_type == "attention":
        return UNetAttention(resolve_channels(n_channels), n_classes, base,
                             dropout, dropout_p, generator=generator)
    if model_type in TRANSUNET_TYPES:
        raise ValueError(f"model_type {model_type!r} is built by "
                         "models.transunet.build_transunet")
    not_ported.check(not_ported.MODEL_TYPES, "model_type", model_type)
    raise ValueError(f"Invalid model_type {model_type!r}")
