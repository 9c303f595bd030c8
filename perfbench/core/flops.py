"""The work of a configuration's reference model, at its shape on the meta
device: the FLOPs of its products an image (torch's FlopCounterMode:
convolutions, linear layers and matmuls, a multiply-add counting two),
forward alone or forward and backward through every tensor it returns
(the weights' gradients and the activations' that they need, nothing
recomputed), and the calls it records for the kernels' bounds
(reference/ops.py)."""

from __future__ import annotations

import importlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.ops import Ops


def count(spec: dict, train: bool, batch: int = 1):
    """(FLOPs, records) of one forward (and backward with `train`) at
    `batch` images of the configuration's input shape."""
    module = importlib.import_module(f"perfbench.reference.{spec['reference']}")
    m = spec["model"]
    with torch.device("meta"):
        model = module.build(spec)
        x = torch.empty(batch, m["img_size"], m["img_size"], m["in_channels"])
    ops = Ops("f32")
    with FlopCounterMode(display=False) as counter:
        out = model(x, ops, train=train)
        if train:
            total(out).backward()
    return counter.get_total_flops(), ops.records


def total(out) -> torch.Tensor:
    """The sum of every tensor of a reference's output: one tensor, or a
    tuple, list or dict of them (a detector's logits and points)."""
    if isinstance(out, torch.Tensor):
        return out.float().sum()
    parts = out.values() if isinstance(out, dict) else out
    return sum(total(p) for p in parts)
