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
"""

from __future__ import annotations

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


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The concatenation along dim 0 of every rank's `x` (all of one shape)
    in the group's rank order, by the all-reduce of zero-padded tensors
    (gloo on CUDA tensors runs all_reduce, not all_gather). Not
    differentiable. None: `x`."""
    if group is None:
        return x
    n, index = x.shape[0], dist.get_rank(group)
    full = x.new_zeros((n * dist.get_world_size(group), *x.shape[1:]))
    full[index * n:(index + 1) * n] = x
    return all_reduce_(full, group)


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
