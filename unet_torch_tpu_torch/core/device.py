"""Device resolution.

The JAX package takes whatever `jax.devices()` offers. The port is told its
device: "cuda" (or "cuda:N") means the GPU, and raises where there is none;
"cpu" runs the plain PyTorch versions of the kernels. Nothing here picks the
CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        if (device.index is not None
                and device.index >= torch.cuda.device_count()):
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} GPU(s) exist")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return device
