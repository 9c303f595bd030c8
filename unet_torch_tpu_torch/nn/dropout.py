"""Dropout drawn from an explicit generator (counterpart of
unet_torch_tpu/nn/blocks.py::TPUDropout, whose masks come from the train
step's `rng`).

torch's own dropout draws from the global RNG, which nothing in the port
seeds. Here every mask comes from the `torch.Generator` that the train step
binds with `set_dropout_generator` (it must live on the activations'
device), so a run is reproducible from its seed. Inverted dropout: P(keep)
= 1 - p, survivors scaled by 1 / (1 - p), identity in eval mode.

In a data-, tensor- or spatially parallel step (core/mesh.py) every rank
binds the same generator state and draws the mask of the whole batch, then
applies its slice: its batch rows; where the input is split over the model
ranks (the column-parallel fc1 / linear1 output: `model_dim`), its
columns; under a spatial mesh, its strip along the dim the caller names
(`spatial_dim`: the height of an NCHW activation by default, the tokens of
a (B, N, C) sequence whose strips are the image's rows, None where the
input is replicated over the strips, as CLTR's decoder is). A rank's
dropout then equals the one-process port's on its share, and the ranks'
generators stay in step.
"""

from __future__ import annotations

import torch
from torch import nn


class MeshBound:
    """A module whose train forward depends on the rank's place in the
    (data, model) layout, bound by `set_mesh`; None is one process."""

    mesh = None

    @property
    def strip_group(self):
        """The model group of a spatial mesh, whose ranks hold the strips
        of the image's height, or None (one strip: the whole image)."""
        mesh = self.mesh
        if mesh is None or mesh.role != "spatial":
            return None
        return mesh.model_group


def set_mesh(module: nn.Module, mesh) -> None:
    """Bind `mesh` (core/mesh.py::Mesh, or None) to every MeshBound module
    of `module`: the dropouts and the attentions."""
    for m in module.modules():
        if isinstance(m, MeshBound):
            m.mesh = mesh


class Dropout(MeshBound, nn.Module):
    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator: torch.Generator | None = None

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x, model_dim: int | None = None,
                spatial_dim: int | None = 2):
        """`model_dim`: the dim of x split over the model ranks of a tensor-
        parallel mesh, or None where x is replicated over them;
        `spatial_dim`: the same under a spatial mesh (module docstring)."""
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs a generator: call "
                               "set_dropout_generator(model, generator)")
        shape = list(x.shape)
        mesh = self.mesh
        if mesh is not None and mesh.role == "spatial":
            model_dim = spatial_dim
        if mesh is not None:
            shape[0] *= mesh.data
            if model_dim is not None:
                shape[model_dim] *= mesh.model
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if mesh is not None:
            u = u.narrow(0, mesh.d * x.shape[0], x.shape[0])
            if model_dim is not None:
                u = u.narrow(model_dim, mesh.m * x.shape[model_dim],
                             x.shape[model_dim])
        keep = u >= self.p
        return torch.where(keep, x * (1.0 / (1.0 - self.p)), 0.0)


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Bind `generator` to every Dropout of `module` (the ViT's attention
    draws its per-step dropout seeds from its out-projection Dropout's)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
