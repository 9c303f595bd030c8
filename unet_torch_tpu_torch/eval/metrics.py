"""Eval-side tensor metrics (counterpart of unet_torch_tpu/eval/metrics.py)."""

from __future__ import annotations

import torch


def class_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Class map from (..., C) logits: argmax over the trailing class axis,
    first maximum wins (torch.argmax's documented tie rule, as in the JAX
    package's plane compares), returned as uint8.

    Same result as the reference's softmax->argmax chain, since softmax is
    monotone."""
    if logits.shape[-1] > 256:
        raise ValueError(f"{logits.shape[-1]} classes do not fit uint8")
    return torch.argmax(logits, dim=-1).to(torch.uint8)
