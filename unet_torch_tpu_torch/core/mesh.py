"""The (data, model) layout of the ranks (counterpart of
unet_torch_tpu/core/mesh.py).

The JAX package lays its devices out as a `jax.sharding.Mesh` of axes
`data` (batch sharding) and `model` and lets XLA insert the collectives.
The port's ranks are processes, one a card: `world = data * model`, rank =
d * model + m. The ranks that share `d` form the `model_group`, those that
share `m` the data-parallel group (`data_group`), all of them the
`world_group`; rank 0 is the main rank. A group of one rank is None, so
that every collective over it is the identity (core/dist.py).

The model axis has one of three roles, which the mesh names (`role`):
"tensor", the heads and features of the transformer families
(parallel/tensor.py); "spatial", the image's height, in strips
(parallel/spatial.py; the JAX `P("data", "model")` layout of an image
batch); "pipeline", the stages of the ViT encoder (parallel/pipeline.py).
Each module that reads the model axis takes the one role it was written
for and refuses the others, so that a pipeline stage's blocks are never
tensor-parallel shards whose gradients the model group would sum.

`shard_batch` is the host-to-device crossing of a rank's share of the
batch, the port's counterpart of the JAX `shard_batch` and
`prefetch_to_device`: the loader already yields the rank's share
(`NumpyLoader(shard_index=d, num_shards=data)` at `local_batch(batch)`),
and the copy runs from pinned memory without blocking the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from unet_torch_tpu_torch.core.dist import process_count, process_index
from unet_torch_tpu_torch.utils.debug import span


ROLES = ("tensor", "spatial", "pipeline")


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None
    role: str = "tensor"
    world_group: object = None

    @property
    def d(self) -> int:
        """The rank's data index: its share of the batch."""
        return self.rank // self.model

    @property
    def m(self) -> int:
        """The rank's model index: its share of the heads and features, its
        strip of the height or its pipeline stage, by `role`."""
        return self.rank % self.model

    @property
    def size(self) -> int:
        return self.data * self.model

    def local_batch(self, global_batch: int) -> int:
        """A rank's batch, as the JAX CLI's per-process batch (at least 1)."""
        return max(1, int(global_batch) // self.data)

    def rows(self, n_global: int) -> slice:
        """The rank's rows of a global batch of `n_global`."""
        n = n_global // self.data
        return slice(self.d * n, (self.d + 1) * n)

    def strip(self, h_global: int) -> slice:
        """The rank's rows of an image of `h_global` rows (spatial role)."""
        if h_global % self.model:
            raise ValueError(f"height {h_global} does not split into "
                             f"{self.model} equal strips")
        n = h_global // self.model
        return slice(self.m * n, (self.m + 1) * n)

    def check_role(self, role: str, what: str) -> None:
        """Raise unless the model axis has `role` (or one rank)."""
        if self.model > 1 and self.role != role:
            raise ValueError(f"{what} takes a mesh whose model axis has the "
                             f"{role!r} role; this one's is {self.role!r}")


def make_mesh(n_data: int | None = None, n_model: int = 1,
              role: str = "tensor") -> Mesh:
    """The (data, model) layout over the launched ranks, with its process
    groups and the model axis's `role`. `n_data=None` puts every rank not on
    `model` on `data` (the JAX `make_mesh()`); a layout whose product is not
    the world size raises. Every rank must call it, in the same order
    (torch.distributed creates each group on all ranks)."""
    if role not in ROLES:
        raise ValueError(f"mesh role {role!r} is not one of {ROLES}")
    world, rank = process_count(), process_index()
    n_model = int(n_model or 1)
    if n_data is None:
        n_data = world // n_model
    n_data = int(n_data)
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(
            f"mesh data {n_data} x model {n_model} is not the world size "
            f"{world}: a launch of data x model ranks trains such a mesh "
            "(torchrun --nproc_per_node=N), and mesh: {} puts every rank on "
            "data")
    data_group = model_group = world_group = None
    if world > 1:
        world_group = dist.group.WORLD
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if n_data > 1 and rank % n_model == m:
                data_group = group
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if n_model > 1 and rank // n_model == d:
                model_group = group
    return Mesh(n_data, n_model, rank, data_group, model_group, role,
                world_group)


def mesh_from_config(mesh_cfg: dict | None) -> Mesh:
    """`train_config.mesh` ({} or {data: D, model: M}) as a Mesh."""
    mesh_cfg = mesh_cfg or {}
    return make_mesh(mesh_cfg.get("data"), mesh_cfg.get("model") or 1)


def shard_batch(arrays, device, dtype=None):
    """numpy arrays of the rank's share -> tensors on `device`, the first in
    `dtype` when given; from pinned memory, not waited for, on a card (the
    pinning inside the span `batch.pin`)."""
    device = torch.device(device)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type == "cuda":
        with span("batch.pin"):
            tensors = [t.pin_memory() for t in tensors]
    tensors = [t.to(device, non_blocking=True) for t in tensors]
    if dtype is not None:
        tensors[0] = tensors[0].to(dtype)
    return tuple(tensors)
