"""Spatial (height) partitioning of the UNet family (counterpart of
unet_torch_tpu/parallel/spatial.py).

The JAX package shards an image batch `P("data", "model")`: the batch over
`data`, the height over `model`, and XLA inserts the halo exchange of every
3x3 conv. The port writes that exchange out. Under a mesh whose model axis
has the "spatial" role (core/mesh.py) rank (d, m) holds its batch rows and
its strip of H / M rows; `spatialize` binds the mesh to the model's
DoubleConvs, which read one row of each neighbouring strip before each conv
(core/dist.py::exchange_rows), and to its dropouts, which draw the whole
batch's mask and keep the rank's rows and strip; the BatchNorms' train
statistics are summed over the world group (every rank holds a share of
the batch's pixels). The max pools, the 2x2 transposed convs, the 1x1 convs
and the attention gates read no row of another strip.

A train step on a strip takes the world group (`mesh.world_group`): the
model under DistributedDataParallel over it, the losses' batch-coupled sums
over it (train/steps.py `group`). The means of per-pixel terms need
nothing more: DDP's mean over equal strips is the whole batch's mean.

A strip's height must be a multiple of 2**DEPTH (16 for the UNet family):
each max pool halves it, and a pool window must not straddle two strips.
XLA reshards such an image; the port raises instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unet_torch_tpu_torch.core.dist import all_reduce_
from unet_torch_tpu_torch.core.mesh import shard_batch
from unet_torch_tpu_torch.models.unet import UNet, UNetAttention, UNetMultitask
from unet_torch_tpu_torch.nn.dropout import set_mesh
from unet_torch_tpu_torch.nn.sync_batchnorm import convert_sync_batchnorm

# the UNet family's max pools
DEPTH = 4
SPATIAL_MODELS = (UNet, UNetMultitask, UNetAttention)


def spatial_layout(mesh, shape) -> tuple | None:
    """The rank's share of an array of `shape`, by the JAX rule: (its batch
    rows, its strip of the height) for one of ndim >= 3 whose batch divides
    into `data` and height into `model`; None (the array replicated) for
    any other."""
    if (len(shape) >= 3 and shape[0] % mesh.data == 0
            and shape[1] % mesh.model == 0):
        return mesh.rows(shape[0]), mesh.strip(shape[1])
    return None


def shard_spatial(mesh, arrays, device, dtype=None) -> tuple:
    """numpy arrays (NHWC images, NHW labels, ...) -> the rank's shares on
    `device` (`spatial_layout`; the first in `dtype` where given)."""
    shares = []
    for a in arrays:
        layout = spatial_layout(mesh, np.shape(a))
        shares.append(a if layout is None else a[layout[0], layout[1]])
    return shard_batch(shares, device, dtype)


def gather_spatial(y: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch of an NHWC output on every rank, from each rank's
    rows and strip (by the all-reduce of zero-padded tensors, which gloo
    runs on CUDA tensors). Not differentiable."""
    b, h = y.shape[:2]
    full = y.new_zeros((b * mesh.data, h * mesh.model, *y.shape[2:]))
    full[mesh.rows(b * mesh.data), mesh.strip(h * mesh.model)] = y
    return all_reduce_(full, mesh.world_group)


def check_strip(height: int) -> None:
    """Raise where a strip of `height` rows cannot be pooled DEPTH times
    within itself."""
    if height % 2 ** DEPTH:
        raise ValueError(
            f"a strip of {height} rows is not a multiple of {2 ** DEPTH}: "
            f"the UNet's {DEPTH} max pools would pair rows of two strips "
            "(XLA reshards such an image; the port does not). Choose a "
            "height that divides into strips of a multiple of "
            f"{2 ** DEPTH} rows")


def _strip_hook(module, args):
    check_strip(args[0].shape[1])


def spatialize(model: nn.Module, mesh) -> nn.Module:
    """The model's place on a spatial mesh: the mesh bound to its
    DoubleConvs and dropouts, its BatchNorms' statistics over the world
    group, and a check that each input strip's height is a multiple of
    2**DEPTH. In place; returns the model. A UNet-family model only: the
    TransUnet and CLTR families raise."""
    mesh.check_role("spatial", "spatialize")
    if not isinstance(model, SPATIAL_MODELS):
        raise NotImplementedError(
            f"{type(model).__name__} is not spatially partitioned by the "
            "port: only the UNet family's convs are local to a strip; a "
            "transformer's attention reads every token of the image, so a "
            "strip would need every other strip's keys and values (XLA "
            "gathers them in the JAX package; ROADMAP queue 1)")
    set_mesh(model, mesh)
    convert_sync_batchnorm(model, mesh.world_group)
    if mesh.model > 1:
        model.register_forward_pre_hook(_strip_hook)
    return model
