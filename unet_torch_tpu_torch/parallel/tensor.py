"""Tensor parallelism of the transformer families (counterpart of
unet_torch_tpu/parallel/tensor.py).

The JAX package writes Megatron's pattern as parameter PartitionSpecs and
lets GSPMD insert the collectives. The port writes it out over the model
group of its (data, model) layout (core/mesh.py), with the roles of the
JAX `_COLUMN` and `_ROW` lists:

  column-parallel  ViT `query`, `key`, `value`, `fc1`; CLTR's q, k and v
                   projections (the thirds of the encoder's stacked
                   `in_proj_weight`) and `linear1`: a rank holds its share of
                   the output features (weight rows, bias); the forward is
                   the identity on the input, the backward sums the input's
                   gradient over the group (core/dist.py::copy_to_group)
  row-parallel     ViT `out`, `fc2`; CLTR `out_proj`, `linear2`: a rank
                   holds its share of the input features (weight columns);
                   the forward sums the partial outputs over the group and
                   adds the bias once, after the sum
                   (core/dist.py::reduce_from_group); the backward is the
                   identity

Attention then runs on num_heads / model heads a rank (the models'
attention modules read the rank's place from the bound mesh); every other
parameter is replicated. Each model rank computes the replicated
parameters' gradients itself, and cuDNN's convolution gradients are not
bitwise reproducible, so the replicas would drift apart step by step (two
ranks' TransUnet logits read 1.95 apart at a peak of 9.5 after 14 steps on
an H100): `average_replicated_grads`, which every train step calls after
its backward, averages those gradients over the model group, one
all-reduce a step. The optimizer is built over the sharded
parameters, so Adam's moments follow their shards. `gather_state_tp` is the
inverse of `shard_model_tp`: the full, unsharded state dict, which the
checkpoints hold.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unet_torch_tpu_torch.core.dist import (
    all_reduce_,
    copy_to_group,
    reduce_from_group,
)
from unet_torch_tpu_torch.models.cltr.transformer import (
    FullAttention,
    RawAttention,
)
from unet_torch_tpu_torch.models.transunet.vit import Attention, Linear
from unet_torch_tpu_torch.nn.dropout import set_mesh
from unet_torch_tpu_torch.nn.sync_batchnorm import convert_sync_batchnorm

# module names by role (the JAX package's lists; CLTR's q, k and v are the
# thirds of FullAttention's stacked projection)
_COLUMN = ("query", "key", "value", "fc1", "linear1")
_ROW = ("out", "fc2", "out_proj", "linear2")


def _share(t: torch.Tensor, dim: int, chunks: int, m: int, model: int):
    """Rank m's share of `t` along `dim`, taken from each of `chunks` equal
    blocks of that dim."""
    return torch.cat([c.chunk(model, dim)[m] for c in t.chunk(chunks, dim)],
                     dim)


def _gather(t: torch.Tensor, dim: int, chunks: int, m: int, model: int,
            group) -> torch.Tensor:
    """The inverse of `_share`: the whole tensor on every rank of the group,
    by the all-reduce of zero-padded blocks."""
    blocks = []
    for c in t.chunk(chunks, dim):
        shape = list(c.shape)
        shape[dim] *= model
        full = c.new_zeros(shape)
        full.narrow(dim, m * c.shape[dim], c.shape[dim]).copy_(c)
        blocks.append(all_reduce_(full, group))
    return torch.cat(blocks, dim)


class ColumnParallelLinear(Linear):
    """A Linear holding rank m's share of the output features."""

    tp_dims = {"weight": (0, 1), "bias": (0, 1)}

    def __init__(self, in_features, out_features, group, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_group(x, self.group))


class RowParallelLinear(Linear):
    """A Linear holding rank m's share of the input features; the bias is
    whole and added once, after the sum over the group."""

    tp_dims = {"weight": (1, 1)}

    def __init__(self, in_features, out_features, group, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)
        self.group = group

    def forward(self, x):
        y = reduce_from_group(F.linear(x, self.weight.to(x.dtype)),
                              self.group)
        return y + self.bias.to(y.dtype)


def _split(linear: Linear, cls, mesh) -> Linear:
    m, model = mesh.m, mesh.model
    weight = linear.weight.detach()
    dim = cls.tp_dims["weight"][0]
    in_f = linear.in_features // model if dim == 1 else linear.in_features
    out_f = linear.out_features // model if dim == 0 else linear.out_features
    new = cls(in_f, out_f, mesh.model_group, device=weight.device,
              dtype=weight.dtype)
    with torch.no_grad():
        new.weight.copy_(_share(weight, dim, 1, m, model))
        bias = linear.bias.detach()
        new.bias.copy_(_share(bias, 0, 1, m, model) if "bias" in cls.tp_dims
                       else bias)
    return new


def _check_heads(model: nn.Module, n_model: int) -> None:
    for mod in model.modules():
        if isinstance(mod, (Attention, RawAttention)) \
                and mod.num_heads % n_model:
            raise ValueError(f"num_heads {mod.num_heads} is not a multiple of "
                             f"the mesh's model {n_model}: tensor "
                             "parallelism splits the heads")


def shard_model_tp(model: nn.Module, mesh) -> nn.Module:
    """Rank (d, m)'s share of a transformer model whose parameters are
    whole: the column- and row-parallel projections are replaced by their
    shares, the encoder's stacked q, k, v sliced by heads, and the mesh is
    bound to the dropouts and attentions. In place; returns the model. A
    mesh of model 1 only binds the mesh."""
    mesh.check_role("tensor", "tensor parallelism")
    set_mesh(model, mesh)
    if mesh.model == 1:
        return model
    _check_heads(model, mesh.model)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is Linear and name in _COLUMN:
                setattr(parent, name, _split(child, ColumnParallelLinear,
                                             mesh))
            elif type(child) is Linear and name in _ROW:
                setattr(parent, name, _split(child, RowParallelLinear, mesh))
        if isinstance(parent, FullAttention):
            parent.tp_dims = {"in_proj_weight": (0, 3),
                              "in_proj_bias": (0, 3)}
            for pname in parent.tp_dims:
                p = getattr(parent, pname)
                p.data = _share(p.data, 0, 3, mesh.m, mesh.model)
    sharded = {id(getattr(mod, name)) for mod in model.modules()
               for name in getattr(mod, "tp_dims", {})}
    model.tp_replicated = [p for p in model.parameters()
                           if id(p) not in sharded]
    model.tp_mesh = mesh
    return model


@torch.no_grad()
def average_replicated_grads(model: nn.Module) -> None:
    """After the backward of a tensor-parallel model (or its
    DistributedDataParallel wrapper): the mean over the model group of the
    gradients of the parameters that every model rank holds whole, so that
    the replicas take the same step. Anything else: nothing."""
    model = getattr(model, "module", model)
    params = [p for p in getattr(model, "tp_replicated", ())
              if p.grad is not None]
    if not params:
        return
    mesh = model.tp_mesh
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, mesh.model_group).div_(mesh.model)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


@torch.no_grad()
def gather_state_tp(model: nn.Module, mesh, tensors: dict | None = None
                    ) -> dict:
    """The model's full, unsharded state dict (every rank of the model group
    must call it; the tensors stay on their device). The inverse of
    `shard_model_tp`: it loads into a model built in one process. With
    `tensors` (by parameter name, as the gradients), those, gathered
    alike."""
    state = dict(model.state_dict() if tensors is None else tensors)
    if mesh is None or mesh.model == 1:
        return state
    for prefix, mod in model.named_modules():
        for pname, (dim, chunks) in getattr(mod, "tp_dims", {}).items():
            key = f"{prefix}.{pname}" if prefix else pname
            state[key] = _gather(state[key], dim, chunks, mesh.m, mesh.model,
                                 mesh.model_group)
    return state


def parallelize(model: nn.Module, mesh) -> nn.Module:
    """The model's place in a (data, model) layout: the transformer
    projections sharded over the model ranks (`shard_model_tp`), the
    BatchNorms' train statistics summed over the data ranks
    (nn/sync_batchnorm.py), the mesh bound to the dropouts and attentions.
    None (one process) leaves the model as it is. In place; returns it."""
    if mesh is None:
        return model
    shard_model_tp(model, mesh)
    convert_sync_batchnorm(model, mesh.data_group)
    return model
