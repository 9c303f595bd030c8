"""Checkpoints (counterpart of unet_torch_tpu/ckpt/__init__.py).

The port reads the reference's own format: a torch `state_dict` saved with
torch.save as models/best.pt (or epoch{N}.pt, last_epoch.pt). The JAX
package's msgpack checkpoints go through ckpt/bridge.py first.
"""

from __future__ import annotations

import torch
from torch import nn


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Read a state_dict `.pt` and load it into `model`; every key must
    match (strict), and every shape."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state_dict, strict=True)
    return model
