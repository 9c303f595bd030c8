"""Pipeline parallelism (GPipe) of the ViT encoder (counterpart of
unet_torch_tpu/parallel/pipeline.py).

The JAX package splits the encoder's L identical pre-LN blocks into S
contiguous stages over the `model` mesh axis and runs microbatches through
them in a `lax.scan` of `ppermute` hops; autodiff reverses the schedule.
The port writes both directions out. Under a mesh whose model axis has the
"pipeline" role (core/mesh.py) rank (d, s) keeps layers [s L/S, (s+1) L/S)
(`stage_layers`, the counterpart of `stack_block_params`); `pipeline_blocks`
splits the rank's batch into M microbatches, and for each in turn stage s
receives the residual stream from stage s - 1 (core/dist.py::recv_prev),
runs its blocks and sends it on (`send_next`); the last stage's outputs
reach every stage (`broadcast_from`, the counterpart of the JAX `psum`).

Differentiable: the forward is one autograd node. It keeps each
microbatch's graph, and its backward walks the microbatches in reverse
order on every rank, so that each stage's sends and receives pair up: the
last stage differentiates its outputs with the mean of the ranks'
gradients of their copies of the output (each rank computes the one loss;
their sum would count it S times), every other stage receives its outputs'
gradients from the next stage and sends its inputs' to the previous one;
stage 0's gradient of the input reaches every stage, whose embeddings fed
it. The blocks' attention is then the differentiable FlashAttention (the
train forward and backward kernels on a card); under `no_grad` the eval
kernel runs.

A stage's blocks are not tensor-parallel shards: the pipeline refuses
blocks bound to a tensor-parallel mesh (their replicated inputs' gradients
would be summed over the stages).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from unet_torch_tpu_torch.core.dist import (
    all_reduce_,
    broadcast_adjoint,
    broadcast_from,
    recv_prev,
    send_next,
)
from unet_torch_tpu_torch.losses import get_loss_fn
from unet_torch_tpu_torch.nn.dropout import set_dropout_generator
from unet_torch_tpu_torch.train.optim import clip_gradients

_LAYERS = "transformer.encoder.layer."


def _stages(mesh):
    """(the number of stages, this rank's, the stages' group)."""
    if mesh is None:
        return 1, 0, None
    mesh.check_role("pipeline", "a pipeline")
    return mesh.model, mesh.m, mesh.model_group


def _check_blocks(blocks) -> None:
    for m in blocks.modules():
        mesh = getattr(m, "mesh", None)
        if mesh is not None and mesh.model > 1 and mesh.role == "tensor":
            raise ValueError(
                "a pipeline stage's blocks are bound to a tensor-parallel "
                "mesh: the model group would sum their replicated inputs' "
                "gradients over the stages. Under a pipeline the model axis "
                "holds the stages; bind no mesh to the blocks")


def stage_layers(encoder: nn.Module, mesh) -> nn.Module:
    """Keep the rank's stage of `encoder.layer`: layers [s L/S, (s+1) L/S).
    In place; returns the encoder. Raises where L does not divide into S
    stages, or where the blocks are tensor-parallel shards."""
    n_stages, s, _ = _stages(mesh)
    _check_blocks(encoder.layer)
    n_layers = len(encoder.layer)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    encoder.layer = nn.ModuleList(encoder.layer[s * per:(s + 1) * per])
    return encoder


@torch.no_grad()
def gather_stage_state(model: nn.Module, mesh, tensors: dict | None = None
                       ) -> dict:
    """The one-process state dict of a model whose encoder holds one stage
    (`stage_layers`), on every rank of the stages' group, bit for bit (each
    stage's tensors broadcast from its rank); the counterpart of
    `unstack_block_params`. Every rank of the group must call it. With
    `tensors` (by parameter name, as the gradients), those, gathered
    alike."""
    n_stages, s, group = _stages(mesh)
    state = dict(model.state_dict() if tensors is None else tensors)
    if n_stages == 1:
        return state
    per = len(model.transformer.encoder.layer)
    local = {k[len(_LAYERS):]: v for k, v in state.items()
             if k.startswith(_LAYERS)}
    out = {k: v for k, v in state.items() if not k.startswith(_LAYERS)}
    for stage in range(n_stages):
        src = dist.get_global_rank(group, stage)
        for name, t in local.items():
            index, rest = name.split(".", 1)
            buf = t.clone() if stage == s else torch.empty_like(t)
            dist.broadcast(buf, src, group=group)
            out[f"{_LAYERS}{stage * per + int(index)}.{rest}"] = buf
    return out


def _fold(seed: int, microbatch: int, layer: int) -> int:
    """The generator seed of one (layer, microbatch), from the call's."""
    return ((int(seed) * 1000003 + microbatch) * 1000003 + layer) % 2 ** 63


class _Schedule:
    """One call's pipeline: the stage's blocks over M microbatches."""

    def __init__(self, mesh, blocks, n_microbatches, dtype, train, seed):
        self.n_stages, self.stage_index, self.group = _stages(mesh)
        self.blocks, self.m = blocks, n_microbatches
        self.dtype, self.train, self.seed = dtype, train, seed
        self.params = [p for p in blocks.parameters()]

    def stage(self, h, microbatch):
        first = self.stage_index * len(self.blocks)
        for j, block in enumerate(self.blocks):
            if self.train:
                set_dropout_generator(block, torch.Generator(
                    h.device).manual_seed(_fold(self.seed, microbatch,
                                                first + j)))
            h = block(h, self.dtype)
        return h

    def forward(self, x, record: bool):
        """The broadcast output and, with `record`, each microbatch's
        (input anchor, end of graph)."""
        n_stages, s, group = self.n_stages, self.stage_index, self.group
        xm = x.reshape(self.m, x.shape[0] // self.m, *x.shape[1:])
        # the residual stream's dtype after a block
        like = torch.empty(xm.shape[1:], device=x.device,
                           dtype=torch.promote_types(x.dtype, self.dtype))
        outs, graphs = [], []
        for i in range(self.m):
            if s == 0:
                anchor = h = (xm[i].detach().requires_grad_(x.requires_grad)
                              if record else xm[i])
            else:
                anchor = like.new_zeros(()).requires_grad_(record)
                h = recv_prev(anchor.expand(like.shape), group, tag=i)
            h = self.stage(h, i)
            if s < n_stages - 1:
                end = send_next(h, group, tag=i)
            else:
                end = h
                outs.append(h.detach())
            graphs.append((anchor, end))
        with torch.no_grad():
            local = (torch.cat(outs) if s == n_stages - 1 else
                     like.new_empty((x.shape[0], *like.shape[1:])))
            out = broadcast_from(local, n_stages - 1, group)
        return out, graphs

    def backward(self, graphs, g, x_dtype, needs_dx: bool):
        """The gradients of the input (None unless `needs_dx`) and of the
        stage's parameters, the microbatches in reverse order."""
        n_stages, s, group = self.n_stages, self.stage_index, self.group
        if group is not None:
            g = broadcast_adjoint(g, n_stages - 1, group)
        gm = g.reshape(self.m, g.shape[0] // self.m, *g.shape[1:])
        dparams = [None] * len(self.params)
        dxs = []
        for i in reversed(range(self.m)):
            anchor, end = graphs[i]
            wrt = self.params + ([anchor] if anchor.requires_grad else [])
            got = torch.autograd.grad(
                end, wrt, gm[i] if s == n_stages - 1 else torch.zeros_like(
                    end), allow_unused=True)
            for k, d in enumerate(got[:len(self.params)]):
                if d is not None:
                    dparams[k] = d if dparams[k] is None else dparams[k] + d
            if s == 0 and anchor.requires_grad:
                dxs.append(got[-1])
        dx = None
        if needs_dx:
            dx = torch.cat(dxs[::-1]) if s == 0 else torch.empty(
                g.shape, dtype=x_dtype, device=g.device)
            if group is not None:
                dist.broadcast(dx, dist.get_global_rank(group, 0),
                               group=group)
        return dx, dparams


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *params):
        ctx.sched, ctx.x_dtype = sched, x.dtype
        with torch.enable_grad():
            out, ctx.graphs = sched.forward(x, record=True)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, dparams = ctx.sched.backward(ctx.graphs, g, ctx.x_dtype,
                                         ctx.needs_input_grad[1])
        ctx.graphs = None
        return (None, dx, *dparams)


def pipeline_blocks(mesh, blocks: nn.ModuleList, x: torch.Tensor,
                    n_microbatches: int, dtype, train: bool = False,
                    seed: int | None = None) -> torch.Tensor:
    """Apply the rank's stage `blocks` (`stage_layers`) of an S-stage GPipe
    to `x`, the rank's batch of residual streams (B, tokens, hidden); each
    block computes in `dtype`. Returns the last stage's output, of x's shape
    in the stream's dtype, on every stage. Differentiable in `x` and the
    blocks' parameters (module docstring).

    The batch splits into `n_microbatches`; the global batch (B times the
    `data` axis) must, and so must each microbatch into the `data` axis, as
    in the JAX package. With `train`, the blocks run in train mode, each
    (layer, microbatch)'s dropout from a generator seeded from `seed` folded
    with both (the JAX `fold_in`); the blocks' modes are restored after."""
    _check_blocks(blocks)
    n_data = 1 if mesh is None else mesh.data
    batch = x.shape[0] * n_data
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{n_microbatches} microbatches")
    microbatch = batch // n_microbatches
    if microbatch % n_data:
        raise ValueError(f"microbatch size {microbatch} not divisible by the "
                         f"'data' axis ({n_data})")
    sched = _Schedule(mesh, blocks, n_microbatches, dtype, train,
                      0 if seed is None else seed)
    modes = [(m, m.training) for m in blocks.modules()]
    blocks.train(train)
    try:
        if torch.is_grad_enabled() and (x.requires_grad or any(
                p.requires_grad for p in sched.params)):
            out = _Pipeline.apply(sched, x, *sched.params)
        else:
            out = sched.forward(x, record=False)[0]
    finally:
        for m, mode in modes:
            m.training = mode
    return out.reshape(x.shape)


def pipelined_vit_forward(model, x: torch.Tensor, mesh,
                          n_microbatches: int) -> torch.Tensor:
    """A VisionTransformer's eval forward, NHWC in and out, with its
    encoder's blocks pipelined (the model's encoder holds the rank's stage):
    the embeddings, the final encoder LayerNorm, the decoder and the head
    run replicated over the stages. The model must be in eval mode, as the
    JAX function runs every layer (BN on its running statistics).
    Differentiable, as the JAX dry run's pipelined SGD step needs."""
    if model.training:
        raise ValueError("pipelined_vit_forward is the eval-mode forward; "
                         "call model.eval() first")
    if x.shape[-1] == 1:  # gray -> RGB
        x = x.repeat(1, 1, 1, 3)
    dtype = x.dtype
    t = model.transformer
    emb, features = t.embeddings(x.permute(0, 3, 1, 2))
    encoded = pipeline_blocks(mesh, t.encoder.layer, emb, n_microbatches,
                              dtype)
    encoded = t.encoder.encoder_norm(encoded).to(dtype)
    return model.segmentation_head(model.decoder(encoded, features))


@torch.no_grad()
def average_pipeline_grads(model: nn.Module, mesh) -> None:
    """After the backward of a pipelined model: every gradient's mean over
    the data group, and the replicated parameters' (all but the stage's
    blocks) over the stages, whose copies computed the same gradient (the
    mean keeps their replicas bitwise in step); one all-reduce each."""
    _, _, group = _stages(mesh)
    stage = {id(p) for p in model.transformer.encoder.layer.parameters()}
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    for members, g, n in (
            (grads, mesh.data_group, mesh.data),
            ([p.grad for p in model.parameters()
              if p.grad is not None and id(p) not in stage], group,
             mesh.model)):
        if g is None or not members:
            continue
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in members]),
                           g).div_(n)
        offset = 0
        for t in members:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_pipeline_step(loss_type: str, num_classes: int, mesh,
                       n_microbatches: int):
    """The JAX dry run's pipelined step: the eval-mode pipelined forward,
    the loss (its batch-coupled sums over the data group), backward, the
    gradients averaged (`average_pipeline_grads`), the optimizer's step.
    Returns step(model, opt, x, y, lr) -> the loss, its mean over the data
    ranks, on the device."""
    data_group = None if mesh is None else mesh.data_group
    loss_fn = get_loss_fn(loss_type, num_classes, group=data_group)

    def step(model, opt, x, y, lr):
        model.eval()
        for param_group in opt.param_groups:
            param_group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(pipelined_vit_forward(model, x, mesh,
                                             n_microbatches), y)
        loss.backward()
        if mesh is not None:
            average_pipeline_grads(model, mesh)
        clip_gradients(opt)
        opt.step()
        loss = loss.detach()
        if data_group is not None:
            loss = all_reduce_(loss.clone(), data_group) / mesh.data
        return loss

    return step
