"""Multi-process training (counterpart of unet_torch_tpu/core/dist.py).

A launch of several processes, one a rank,

    torchrun --nproc_per_node=N -m unet_torch_tpu_torch.cli.train_cli cfg.yml

sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT; `maybe_initialize` reads them and starts `torch.distributed`.
The backend is NCCL where every rank has a card of its own and gloo on the
CPU; gloo also runs `all_reduce` and `broadcast` on CUDA tensors, which is
all that the port's data and tensor parallelism use, so several ranks may
share one card over gloo (NCCL refuses two ranks on one device).

`is_main` guards the host-side artifacts (logs, checkpoints, CSVs, plots),
as the JAX package's does. `all_reduce_sum` is the autograd-aware sum over a
process group: its backward is the same sum of the gradients, so that a
term formed from all ranks' shares (a Dice sum, a BatchNorm statistic) and
averaged by DistributedDataParallel gives every parameter its one-process
gradient. A group of None is one process: every collective here is then the
identity.

`all_gather_dim` concatenates the ranks' shares along a dim (the keys and
values of every strip of an image's tokens); its backward hands each rank
the sum over the ranks of the gradient of its share, which is a
reduce-scatter. `exclusive_prefix_sum` adds the shares of the ranks before
this one (the rows of the strips above, for a position embedding's
cumulative count); its backward adds the gradients of the ranks after it.
Both run on `all_reduce` of zero-padded tensors, which gloo runs on CUDA
tensors.

The point-to-point ops move tensors between neighbours of a group, in its
rank order: `exchange_rows`, the halo of a strip of the image's height
(parallel/spatial.py), and `send_next` / `recv_prev` / `broadcast_from`, the
stage handoffs of a pipeline (parallel/pipeline.py). Each is differentiable,
its backward the adjoint of its forward. Gloo's `send` and `recv` take CPU
tensors only, so under gloo a CUDA tensor crosses through a pinned host
buffer; under NCCL it goes directly. Every one is posted through
`batch_isend_irecv` (NCCL needs a rank's sends and receives to one peer in
one group call) and waited for at most P2P_TIMEOUT, so that a peer that never
answers raises instead of hanging the step.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# what a launcher (torchrun) sets for every rank
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def _check_backend(backend: str) -> None:
    """NCCL needs a card of its own for every rank on this host: raise
    where the launch puts more ranks on the host than it has cards."""
    if backend != "nccl":
        return
    local_world = _env_int("LOCAL_WORLD_SIZE", 1)
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(
            f"backend 'nccl' needs a card of its own for every rank: "
            f"{local_world} ranks on this host and {cards} card(s); NCCL "
            "refuses two ranks on one device, so ranks that share a card "
            "use backend 'gloo'")


def maybe_initialize(force: bool = False, backend: str | None = None) -> bool:
    """Start torch.distributed when a launcher set WORLD_SIZE > 1, or when
    `force` (the config's `distributed: true`) asks for it; idempotent.
    Returns True where more than one process trains.

    `backend` defaults to NCCL with a card and gloo without. Raises, with
    the reason and before anything starts, where `force` or WORLD_SIZE > 1
    finds no launcher environment (as `jax.distributed.initialize()` fails
    without a coordinator), and where NCCL would put two ranks on one
    card."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = _env_int("WORLD_SIZE", 1)
    if not force and world <= 1:
        return False
    missing = [k for k in _LAUNCHER_ENV if not os.environ.get(k)]
    if missing:
        why = ("distributed: true" if force else f"WORLD_SIZE={world}")
        raise RuntimeError(
            f"{why} needs a launcher: {', '.join(missing)} not set; launch "
            "the ranks with torchrun --nproc_per_node=N -m "
            "unet_torch_tpu_torch.cli.train_cli <config.yml> (the JAX "
            "package's jax.distributed.initialize() fails alike without a "
            "coordinator)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    _check_backend(backend)
    dist.init_process_group(backend, init_method="env://",
                            rank=_env_int("RANK", 0), world_size=world)
    return world > 1


def shutdown() -> None:
    """End the launch's process group, where one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rank() -> int:
    """The rank's index on its host (LOCAL_RANK), which names its card."""
    return _env_int("LOCAL_RANK", 0)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on the rank that writes the host-side artifacts (rank 0)."""
    return process_index() == 0


def broadcast_value(values) -> tuple:
    """Rank 0's floats `values`, on every rank (outside a launch: as
    given)."""
    if not dist.is_initialized():
        return tuple(values)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, src=0)
    return tuple(t.tolist())


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place, outside autograd; None: nothing."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over `group`, outside autograd (a step's reported
    loss); None: `x`."""
    if group is None:
        return x
    return all_reduce_(x.clone(), group) / dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable: the
    backward sums the gradients over the same ranks. None: `x` itself."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, index = x.shape[dim], dist.get_rank(group)
        shape = list(x.shape)
        shape[dim] *= dist.get_world_size(group)
        full = x.new_zeros(shape)
        full.narrow(dim, index * n, n).copy_(x)
        return all_reduce_(full, group)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        n = g.shape[dim] // dist.get_world_size(group)
        total = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                            group)
        return (total.narrow(dim, dist.get_rank(group) * n, n).contiguous(),
                None, None)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` (all of one shape) concatenated along `dim` in the
    group's rank order, on every rank. Differentiable: each rank
    differentiates its own loss, so the gradient of a rank's share is the
    sum over the ranks of their gradients of it (a reduce-scatter). None:
    `x`."""
    if group is None:
        return x
    return _AllGatherDim.apply(x, group, dim)


def _stacked(x: torch.Tensor, group) -> torch.Tensor:
    """(size, *x.shape): every rank's `x` by its rank in `group`."""
    full = x.new_zeros((dist.get_world_size(group), *x.shape))
    full[dist.get_rank(group)] = x
    return all_reduce_(full, group)


class _ExclusivePrefixSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _stacked(x, group)[:dist.get_rank(group)].sum(0)

    @staticmethod
    def backward(ctx, g):
        index = dist.get_rank(ctx.group)
        return _stacked(g.contiguous(), ctx.group)[index + 1:].sum(0), None


def exclusive_prefix_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` before this one (zeros on
    the first), differentiable: the gradient of a rank's `x` is the sum of
    the gradients of the ranks after it. None: zeros."""
    if group is None:
        return torch.zeros_like(x)
    return _ExclusivePrefixSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the identity forward, the gradient summed over `group`
    backward. It enters a tensor replicated over the group into products
    each rank holds a share of. None: `x`."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over `group` forward, the identity backward. It
    adds the ranks' partial products into a replicated tensor. None: `x`."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


# the longest a point-to-point op waits for its peer before it raises
P2P_TIMEOUT = datetime.timedelta(seconds=300)


def _staged(t: torch.Tensor, group) -> bool:
    """True where `t` crosses through a host buffer: a CUDA tensor under
    gloo, whose point-to-point ops take CPU tensors only."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _p2p(group, sends, recvs) -> list:
    """Post `sends` [(tensor, peer, tag)] and `recvs` [(like, peer, tag)],
    peers by their rank in `group`, and wait for all of them; returns a
    received tensor for each of `recvs`, of its `like`'s shape, dtype and
    device."""
    ops, out = [], []
    for t, peer, tag in sends:
        t = t.detach()
        if _staged(t, group):
            t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        else:
            t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer),
                              group, tag))
    for like, peer, tag in recvs:
        staged = _staged(like, group)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device,
                          pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group, tag))
        out.append(buf)
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait(P2P_TIMEOUT)
    return [buf.to(like.device) for buf, (like, _, _) in zip(out, recvs)]


# the tags of the two directions along a group's rank order
_DOWN, _UP = 0, 1


def _swap_edges(top: torch.Tensor, bottom: torch.Tensor, group):
    """Send `top` to the previous rank of `group` and `bottom` to the next;
    returns (the previous rank's `bottom`, the next rank's `top`), zeros at
    either end of the order. An empty `top` or `bottom` (the same on every
    rank) crosses nowhere."""
    index, size = dist.get_rank(group), dist.get_world_size(group)
    from_prev = index > 0 and bottom.numel() > 0
    from_next = index < size - 1 and top.numel() > 0
    sends, recvs = [], []
    if index > 0 and top.numel():
        sends.append((top, index - 1, _UP))
    if from_prev:
        recvs.append((bottom, index - 1, _DOWN))
    if index < size - 1 and bottom.numel():
        sends.append((bottom, index + 1, _DOWN))
    if from_next:
        recvs.append((top, index + 1, _UP))
    got = _p2p(group, sends, recvs)
    above = got.pop(0) if from_prev else torch.zeros_like(bottom)
    below = got.pop(0) if from_next else torch.zeros_like(top)
    return above, below


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, above, below, dim):
        ctx.group, ctx.above, ctx.below, ctx.dim = group, above, below, dim
        n = x.shape[dim]
        # the first `below` rows go up, the last `above` rows down
        up, down = _swap_edges(x.narrow(dim, 0, below),
                               x.narrow(dim, n - above, above), group)
        return torch.cat([up, x, down], dim)

    @staticmethod
    def backward(ctx, g):
        group, above, below, dim = ctx.group, ctx.above, ctx.below, ctx.dim
        n = g.shape[dim] - above - below
        # the halo rows' gradients go back to the neighbours they came from,
        # and theirs of this strip's edge rows come back here
        top, bottom = _swap_edges(g.narrow(dim, 0, above),
                                  g.narrow(dim, above + n, below), group)
        dx = g.narrow(dim, above, n).clone(
            memory_format=torch.contiguous_format)
        dx.narrow(dim, 0, below).add_(top)
        dx.narrow(dim, n - above, above).add_(bottom)
        return dx, None, None, None, None


def exchange_rows(x: torch.Tensor, group, halo: int = 1, dim: int = 2, *,
                  above: int | None = None,
                  below: int | None = None) -> torch.Tensor:
    """The strip `x` with `above` rows of the previous rank in `group`'s
    rank order before it (that rank's last rows) and `below` rows of the
    next after it (its first rows), along `dim`, both `halo` unless given;
    zero rows at the image's top and bottom: what a conv padded by `above`
    rows at the top and reading `below` rows past the strip's end sees of
    the whole image (a k x k conv with padding p: p and k - 1 - p). The
    backward adds each halo row's gradient into the neighbour's edge row it
    came from."""
    above = halo if above is None else above
    below = halo if below is None else below
    if x.shape[dim] < max(above, below):
        raise ValueError(f"a strip of {x.shape[dim]} rows has no "
                         f"{max(above, below)} rows to exchange")
    return _ExchangeRows.apply(x, group, above, below, dim)


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, like, group, tag):
        ctx.group, ctx.tag = group, tag
        index = dist.get_rank(group)
        return _p2p(group, [], [(like, index - 1, tag)])[0]

    @staticmethod
    def backward(ctx, g):
        _p2p(ctx.group, [(g, dist.get_rank(ctx.group) - 1, ctx.tag)], [])
        return None, None, None


def recv_prev(like: torch.Tensor, group, tag: int = 0) -> torch.Tensor:
    """A tensor of `like`'s shape, dtype and device from the previous rank
    of `group` (its `send_next` of the same tag). Where `like` requires
    grad, the result is a node of the graph whose backward sends the
    gradient back to that rank; `like`, which gives only the shape, gets no
    gradient but anchors the node: differentiate with respect to it to run
    the backward."""
    return _RecvPrev.apply(like, group, tag)


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        ctx.like = (x.shape, x.dtype, x.device)
        _p2p(group, [(x, dist.get_rank(group) + 1, tag)], [])
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        like = torch.empty(shape, dtype=dtype, device=device)
        g = _p2p(ctx.group, [],
                 [(like, dist.get_rank(ctx.group) + 1, ctx.tag)])[0]
        return g, None, None


def send_next(x: torch.Tensor, group, tag: int = 0) -> torch.Tensor:
    """Send `x` to the next rank of `group` (its `recv_prev` of the same
    tag). Returns a 0-d zero, a node of the graph whose backward receives
    the gradient of `x` from that rank: differentiate it (with any
    gradient) to pull the gradient back."""
    return _SendNext.apply(x, group, tag)


def broadcast_adjoint(g: torch.Tensor, src: int, group) -> torch.Tensor:
    """The backward of `broadcast_from`: every rank differentiated its copy
    of the one loss, so their mean is that loss's gradient, which rank
    `src` takes; the others take zero."""
    g = all_reduce_(g.clone(memory_format=torch.contiguous_format),
                    group) / dist.get_world_size(group)
    return g if dist.get_rank(group) == src else torch.zeros_like(g)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, dist.get_global_rank(group, src), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return broadcast_adjoint(g, ctx.src, ctx.group), None, None


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank `src` of `group`'s `x` on every rank of the group (the others'
    `x` gives the shape). Differentiable: each rank differentiates its copy
    of one loss, so the backward hands the source the mean of the ranks'
    gradients (not their sum, which would count the loss once a rank) and
    the others zero. None: `x`."""
    if group is None:
        return x
    return _BroadcastFrom.apply(x, src, group)
