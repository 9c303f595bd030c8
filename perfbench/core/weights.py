"""Weights from the seed, drawn on the device in one call: every leaf of a
state dict, in float32 (the type the port keeps its parameters in),
scaled by a rule of its name and shape. The program's model and the plain
reference take the same values, so both are drawn from the same names."""

from __future__ import annotations

import math

import torch


def _shape_leaf(name: str, v: torch.Tensor) -> torch.Tensor:
    if name.endswith("running_mean"):
        return 0.1 * v
    if name.endswith("running_var"):
        return torch.exp(0.2 * v)
    if name.endswith("position_embeddings"):
        return 0.02 * v
    if v.dim() == 4:  # conv kernels: He-normal over the fan-in
        return v * math.sqrt(2.0 / v[0].numel())
    if v.dim() == 2:  # linear layers
        return v / math.sqrt(v.shape[1])
    if name.endswith("weight"):  # norm gains
        return 1.0 + 0.1 * v
    return 0.05 * v  # biases


def make(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for `shapes` ({name: shape} of a state dict). A
    `num_batches_tracked` counter is 0."""
    names = sorted(n for n in shapes if not n.endswith("num_batches_tracked"))
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, size in zip(names, sizes):
        out[name] = _shape_leaf(name, flat[off:off + size].view(shapes[name]))
        off += size
    for n in shapes:
        if n.endswith("num_batches_tracked"):
            out[n] = torch.zeros((), dtype=torch.long, device=device)
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def materialize(module: torch.nn.Module, seed: int, device):
    """A module built on the meta device, put on `device` with the seed's
    weights."""
    weights = make(shapes_of(module), seed, device)
    module.to_empty(device=device)
    module.load_state_dict(weights, strict=True)
    return module
