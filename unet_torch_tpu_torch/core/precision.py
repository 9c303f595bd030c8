"""Precision policy (counterpart of unet_torch_tpu/core/precision.py).

Parameters stay float32. Under `bf16` the forward computes in bfloat16: the
input is cast once, each layer casts its weights to the activations' dtype,
and the fused conv kernel accumulates and applies BN in float32 before it
rounds. `f32` computes in float32 throughout.
"""

from __future__ import annotations

import torch


def resolve_precision(name: str | None) -> torch.dtype:
    """The compute dtype of a config's `precision`."""
    if name in (None, "f32", "float32", "fp32"):
        return torch.float32
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Unknown precision {name!r}")
