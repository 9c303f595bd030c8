"""Checkpoints (counterpart of unet_torch_tpu/ckpt/__init__.py).

The reference's format: a torch `state_dict` saved with torch.save as
models/epoch{N}.pt, best.pt and last_epoch.pt (`save_weights`, read back
strictly by `load_weights`). The JAX package writes flax msgpack under the
same names; `state_dict_from_jax_payload` converts one, read into numpy by
the caller, through ckpt/bridge.py. A tensor-parallel run saves the full,
unsharded state dict (parallel/tensor.py::gather_state_tp), so that every
checkpoint loads into a model built in one process.

`save_full` / `restore_full` also keep the optimizer's state and the step,
for an exact resume (the reference loses its optimizer moments across
restarts).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from unet_torch_tpu_torch.ckpt.bridge import (
    attention_state_dict_from_flax,
    cltr_flax_from_state_dict,
    cltr_state_dict_from_flax,
    load_pretrained_resnet50,
    state_dict_from_flax,
    transunet_state_dict_from_flax,
)


def _host_state_dict(model: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_state_dict(path: str, state: dict) -> None:
    """A state_dict (moved to the CPU) to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def save_weights(path: str, model: nn.Module) -> None:
    """The model's state_dict (on the CPU) to `path`."""
    save_state_dict(path, model.state_dict())


def load_weights(path: str, model: nn.Module) -> nn.Module:
    """Read a state_dict `.pt` and load it into `model`; every key must
    match (strict), and every shape. A two-head checkpoint trained with the
    uncertainty-weighted loss holds `log_vars`; the model gets that parameter
    first (UNetMultitask.add_log_vars)."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if "log_vars" in state_dict and hasattr(model, "add_log_vars"):
        model.add_log_vars()
    model.load_state_dict(state_dict, strict=True)
    return model


def save_full(path: str, model: nn.Module, opt: torch.optim.Optimizer,
              step: int) -> None:
    """Weights, optimizer state and step."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": _host_state_dict(model),
                "optimizer": opt.state_dict(), "step": int(step)}, path)


def restore_full(path: str, model: nn.Module,
                 opt: torch.optim.Optimizer) -> int:
    """Load what `save_full` wrote into `model` (strict) and `opt`; returns
    the step. The optimizer's state follows its parameters' device."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    return int(payload["step"])


def load_resnet50_checkpoint(path: str) -> dict:
    """A torchvision resnet50 state_dict from a `torch.save` file;
    `load_pretrained_resnet50` installs it."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def state_dict_from_jax_payload(payload: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict from a JAX checkpoint payload
    ({'params': ..., 'batch_stats': ...} as numpy trees, as the JAX
    package's `ckpt.load_weights` returns it): a ConditionalDETR's when the
    params hold `query_embed`, a TransUnet's when they hold a `transformer`,
    a UNetAttention's when they hold `att1`, else a
    UNet's or (with `decoder1` and `decoder2`) a UNetMultitask's. The JAX
    trainer saves the model's params only, so a multitask run's `log_vars`
    are not in the payload."""
    params, batch_stats = payload["params"], payload.get("batch_stats", {})
    if "query_embed" in params:
        return cltr_state_dict_from_flax(params, batch_stats)
    if "transformer" in params:
        return transunet_state_dict_from_flax(params, batch_stats)
    if "att1" in params:
        return attention_state_dict_from_flax(params, batch_stats)
    return state_dict_from_flax(params, batch_stats)
