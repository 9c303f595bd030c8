"""Spatial (height) partitioning of the UNet, TransUnet and CLTR families
(counterpart of unet_torch_tpu/parallel/spatial.py).

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

The transformer families (models/transunet/, models/cltr/) take the same
layout: their convs read their neighbours' rows and their GroupNorms sum
over the strips (nn/strips.py), a strip's tokens are its rows of the patch
grid, and every attention whose queries are image tokens gathers the keys
and values of every strip (core/dist.py::all_gather_dim) and hashes its
dropout mask at the strip's first query row. The TransUnet's decoder runs
on the strips; CLTR's decoder runs replicated on the gathered memory.

A train step on a strip takes the world group (`mesh.world_group`): the
model under DistributedDataParallel over it, the losses' batch-coupled sums
over it (train/steps.py `group`). The means of per-pixel terms need
nothing more: DDP's mean over equal strips is the whole batch's mean.

A CLTR step takes DistributedDataParallel over the world group too, and
the criterion's point count over the data group (train/cltr_steps.py):
the model ranks of one data rank hold the same outputs.

A strip's height must be a multiple of each family's rule (`strip_rule`):
16 for the UNet family (its four max pools) and the hybrid TransUnet (the
R50 root, pool and blocks 2 and 3 each halve it), the patch height for a
plain ViT, 32 for CLTR (ResNet-50 halves it five times). XLA reshards
other images; the port raises instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unet_torch_tpu_torch.core.dist import all_reduce_
from unet_torch_tpu_torch.core.mesh import shard_batch
from unet_torch_tpu_torch.models.cltr.model import ConditionalDETR
from unet_torch_tpu_torch.models.transunet.vit import _TransUnet
from unet_torch_tpu_torch.models.unet import UNet, UNetAttention, UNetMultitask
from unet_torch_tpu_torch.nn.dropout import set_mesh
from unet_torch_tpu_torch.nn.sync_batchnorm import convert_sync_batchnorm

# the UNet family's max pools
DEPTH = 4
SPATIAL_MODELS = (UNet, UNetAttention, UNetMultitask, _TransUnet,
                  ConditionalDETR)


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


UNET_RULE = (2 ** DEPTH, f"the UNet's {DEPTH} max pools would pair rows of "
             "two strips")
HYBRID_RULE = (16, "the R50 root conv, its max pool and the first units of "
               "blocks 2 and 3 each halve the height, and each must start "
               "every strip at an even row")
CLTR_RULE = (32, "ResNet-50 halves the height five times (conv1, the max "
             "pool, layers 2-4), and each must start every strip at an "
             "even row")


def strip_rule(model: nn.Module) -> tuple:
    """(multiple, reason): the rows a strip of `model`'s input must be a
    multiple of, and why."""
    if isinstance(model, (UNet, UNetAttention, UNetMultitask)):
        return UNET_RULE
    if isinstance(model, ConditionalDETR):
        return CLTR_RULE
    if isinstance(model, _TransUnet):
        embeddings = model.transformer.embeddings
        if hasattr(embeddings, "hybrid_model"):
            return HYBRID_RULE
        patch = embeddings.patch_embeddings.kernel_size[0]
        return (patch, f"a {patch}-row patch would straddle two strips")
    names = [c.__name__ for c in SPATIAL_MODELS]
    raise TypeError(f"{type(model).__name__} is none of the spatially "
                    f"partitioned families: {names}")


def check_strip(height: int, rule: tuple = UNET_RULE) -> None:
    """Raise where a strip of `height` rows breaks `rule` (strip_rule's)."""
    multiple, reason = rule
    if height % multiple:
        raise ValueError(
            f"a strip of {height} rows is not a multiple of {multiple}: "
            f"{reason} (XLA reshards such an image; the port does not). "
            "Choose a height that divides into strips of a multiple of "
            f"{multiple} rows")


def spatialize(model: nn.Module, mesh) -> nn.Module:
    """The model's place on a spatial mesh: the mesh bound to its strip
    layers, dropouts and attentions, its BatchNorms' statistics over the
    world group, and a check that each input strip's height keeps the
    family's rule (`strip_rule`). In place; returns the model. A model of
    SPATIAL_MODELS only."""
    mesh.check_role("spatial", "spatialize")
    rule = strip_rule(model)
    set_mesh(model, mesh)
    convert_sync_batchnorm(model, mesh.world_group)
    if mesh.model > 1:
        model.register_forward_pre_hook(
            lambda module, args: check_strip(args[0].shape[1], rule))
    return model
