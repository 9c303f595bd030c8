"""Dropout drawn from an explicit generator (counterpart of
unet_torch_tpu/nn/blocks.py::TPUDropout, whose masks come from the train
step's `rng`).

torch's own dropout draws from the global RNG, which nothing in the port
seeds. Here every mask comes from the `torch.Generator` that the train step
binds with `set_dropout_generator` (it must live on the activations'
device), so a run is reproducible from its seed. Inverted dropout: P(keep)
= 1 - p, survivors scaled by 1 / (1 - p), identity in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator: torch.Generator | None = None

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs a generator: call "
                               "set_dropout_generator(model, generator)")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x * (1.0 / (1.0 - self.p)), 0.0)


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Bind `generator` to every Dropout of `module` (the ViT's attention
    draws its per-step dropout seeds from its out-projection Dropout's)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
